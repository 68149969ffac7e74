"""The comparison that decides ``correct``: a framebuffer that the timed
path produced against the reference's framebuffer of the same call.

A pixel is off where any of its three values is not finite or differs
from the reference's by more than ATOL + RTOL * |reference| (the
card-against-CPU bar of the port's own path comparisons).  Each path
adds to its own pixel, so a pixel that is off is a path that went
elsewhere, or a stage (camera, traversal, shading, NEE, media, the
spectral-to-XYZ sum, the splat) that computed it otherwise.
"""

from __future__ import annotations

import numpy as np

RTOL, ATOL = 1e-4, 1e-6


def pixels_off(img: np.ndarray, ref: np.ndarray) -> float:
    """The share of pixels of img [H, W, 3] that are off against ref."""
    if img.shape != ref.shape:
        return 1.0
    with np.errstate(invalid='ignore'):
        off = ~np.isfinite(img).all(-1) | (
            np.abs(img - ref) > ATOL + RTOL * np.abs(ref)).any(-1)
    return float(off.mean())
