# Frozen copy of corona13_tpu_torch/spectral/colour.py (lines 1-81) as of commit 2084081, for the benchmark's plain reference.
"""Colour space conversions (corona13_tpu/spectral/colour.py).

The matrices are the reference package's numpy tables.
"""

from __future__ import annotations

import numpy as np

ERGB_TO_XYZ = np.array([
    [0.496859, 0.339094, 0.164047],
    [0.256193, 0.678188, 0.065619],
    [0.023290, 0.113031, 0.863978],
], dtype=np.float32)
XYZ_TO_ERGB = np.array([
    [2.689989, -1.276020, -0.413844],
    [-1.022095, 1.978261, 0.043821],
    [0.061203, -0.224411, 1.162859],
], dtype=np.float32)
XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float32)
SRGB_TO_XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=np.float32)
XYZ_TO_ADOBERGB = np.array([
    [2.0413690, -0.5649464, -0.3446944],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0134474, -0.1183897, 1.0154096],
], dtype=np.float32)
ADOBERGB_TO_XYZ = np.array([
    [0.5767309, 0.1855540, 0.1881852],
    [0.2973769, 0.6273491, 0.0752741],
    [0.0270343, 0.0706872, 0.9911085],
], dtype=np.float32)
XYZ_TO_ACES = np.array([
    [1.0498110175, 0.0000000000, -0.0000974845],
    [-0.4959030231, 1.3733130458, 0.0982400361],
    [0.0000000000, 0.0000000000, 0.9912520182],
], dtype=np.float32)
ACES_TO_XYZ = np.array([
    [0.9525523959, 0.0000000000, 0.0000936786],
    [0.3439664498, 0.7281660966, -0.0721325464],
    [0.0000000000, 0.0000000000, 1.0088251844],
], dtype=np.float32)
IDENTITY = np.eye(3, dtype=np.float32)

_TO_XYZ = {'xyz': IDENTITY, 'ergb': ERGB_TO_XYZ, 'srgb': SRGB_TO_XYZ,
           'rec709': SRGB_TO_XYZ, 'adobergb': ADOBERGB_TO_XYZ,
           'aces': ACES_TO_XYZ}
_FROM_XYZ = {'xyz': IDENTITY, 'ergb': XYZ_TO_ERGB, 'srgb': XYZ_TO_SRGB,
             'rec709': XYZ_TO_SRGB, 'adobergb': XYZ_TO_ADOBERGB,
             'aces': XYZ_TO_ACES}


def from_xyz_matrix(space: str) -> np.ndarray:
    return _FROM_XYZ[space]

