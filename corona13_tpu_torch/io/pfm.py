"""PFM (portable float map) image IO (corona13_tpu/io/pfm.py).

The reference's format: header ``PF\\n<w> <h>\\n-1.0\\n`` (negative scale =
little endian) followed by float RGB rows, row 0 at the top.
"""

from __future__ import annotations

import numpy as np


def write_pfm(path: str, img: np.ndarray) -> None:
    """img: [h, w, 3] float32, row 0 at the top."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f'write_pfm needs [h, w, 3], got {img.shape}')
    h, w, _ = img.shape
    with open(path, 'wb') as f:
        f.write(f'PF\n{w} {h}\n-1.0\n'.encode())
        f.write(img.astype('<f4').tobytes())


def read_pfm(path: str) -> np.ndarray:
    """[h, w, 3] (or [h, w, 1] for 'Pf') float32, row 0 at the top."""
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic not in (b'PF', b'Pf'):
            raise ValueError(f'{path}: not a PFM file')
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        nchan = 3 if magic == b'PF' else 1
        dtype = '<f4' if scale < 0 else '>f4'
        data = np.frombuffer(f.read(4 * w * h * nchan), dtype)
    return data.reshape(h, w, nchan).astype(np.float32)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error over all channels, the regression gate
    metric (reference tools/img/pfmdiff.c)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))
