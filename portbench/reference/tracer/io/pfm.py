# Frozen copy of corona13_tpu_torch/io/pfm.py (lines 1-42) as of commit 2084081, for the benchmark's plain reference.
"""PFM (portable float map) image IO (corona13_tpu/io/pfm.py).

The reference's format: header ``PF\\n<w> <h>\\n-1.0\\n`` (negative scale =
little endian) followed by float RGB rows, row 0 at the top.
"""

from __future__ import annotations

import numpy as np


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
