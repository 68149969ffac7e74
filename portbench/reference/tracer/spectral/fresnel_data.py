# Frozen copy of corona13_tpu_torch/spectral/fresnel_data.py (lines 1-53) as of commit 2084081, for the benchmark's plain reference.
"""Measured spectral complex IOR (n, k) for common conductors
(corona13_tpu/spectral/fresnel_data.py): the same tables, sampled at 50 nm
over 400-700 nm, interpolated at the path wavelengths in torch."""

from __future__ import annotations

import numpy as np
import torch

LAM = np.array([400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0], np.float32)

# name -> (n[7], k[7])
CONDUCTORS = {
    'gold': ([1.47, 1.40, 0.84, 0.33, 0.20, 0.14, 0.13],
             [1.95, 1.88, 1.90, 2.32, 2.97, 3.50, 4.10]),
    'au': 'gold',
    'silver': ([0.05, 0.04, 0.05, 0.06, 0.06, 0.05, 0.04],
               [2.07, 2.45, 2.87, 3.32, 3.75, 4.14, 4.52]),
    'ag': 'silver',
    'aluminium': ([0.49, 0.62, 0.77, 0.96, 1.20, 1.47, 1.83],
                  [4.86, 5.47, 6.08, 6.69, 7.26, 7.79, 8.31]),
    'aluminum': 'aluminium',
    'al': 'aluminium',
    'copper': ([1.27, 1.18, 1.12, 0.76, 0.45, 0.22, 0.21],
               [2.16, 2.21, 2.60, 2.46, 2.98, 3.47, 4.05]),
    'cu': 'copper',
    'default': ([0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                [3.0, 3.2, 3.4, 3.6, 3.8, 4.0, 4.2]),
}


def get_conductor(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(n[7], k[7]) float32 arrays for a conductor name (case-insensitive;
    unknown names fall back to 'default')."""
    v = CONDUCTORS.get(name.lower(), CONDUCTORS['default'])
    if isinstance(v, str):
        v = CONDUCTORS[v]
    return (np.asarray(v[0], np.float32), np.asarray(v[1], np.float32))


def eval_nk(n7, k7, lam):
    """Interpolate per-material sampled (n, k) rows at wavelengths lam.

    n7/k7: [..., 7]; lam: [..., MF] in nm.  Returns (n, k) [..., MF]."""
    t = torch.clamp((lam - float(LAM[0])) / 50.0, 0.0, 5.999)
    i0 = t.to(torch.int64)
    f = t - i0
    def lerp(tab):
        tab = tab.expand(lam.shape[:-1] + tab.shape[-1:])
        a = torch.gather(tab, -1, i0)
        b = torch.gather(tab, -1, i0 + 1)
        return a * (1.0 - f) + b * f
    return lerp(n7), lerp(k7)
