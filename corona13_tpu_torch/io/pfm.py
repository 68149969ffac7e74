"""PFM (portable float map) image output (corona13_tpu/io/pfm.py).

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
