"""CIE colour matching and spectral sampling (corona13_tpu/spectral/cie.py).

Wavelengths carry a trailing hero-wavelength axis of size ``mf``; lambda
is in nanometers, sampled uniformly on [360, 830).
"""

from __future__ import annotations

import numpy as np
import torch

from ._cie_data import CIE_LAMBDA_MAX, CIE_LAMBDA_MIN, CIE_STEP, CIE_XYZ_5NM

LAMBDA_MIN = float(CIE_LAMBDA_MIN)
LAMBDA_MAX = float(CIE_LAMBDA_MAX)
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN

# [96, 3] table, last row is a zero pad so lerp at lambda==830 needs no clamp.
CIE_XYZ_TABLE = np.asarray(CIE_XYZ_5NM, dtype=np.float32)
_TABLES: dict = {}


def _table(device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(CIE_XYZ_TABLE, device=device)
    return _TABLES[key]


def sample_lambda_hero(r: torch.Tensor, mf: int):
    """Hero wavelengths from one uniform in [0,1): lane l uses
    frac(r + l/mf).  Returns (lambda[..., mf], pdf[..., mf])."""
    l = torch.arange(mf, dtype=torch.float32, device=r.device) / mf
    rs = torch.remainder(r[..., None] + l, 1.0)
    lam = LAMBDA_MIN + LAMBDA_RANGE * rs
    pdf = torch.full_like(lam, 1.0 / LAMBDA_RANGE)
    return lam, pdf


def xyz_of_lambda(lam: torch.Tensor) -> torch.Tensor:
    """CIE xbar/ybar/zbar at wavelength lam [nm] -> [..., 3] (linear
    interpolation of the 5 nm table; out-of-range wavelengths give 0)."""
    table = _table(lam.device)
    f = (lam - LAMBDA_MIN) / CIE_STEP
    i = torch.clamp(torch.floor(f), 0, table.shape[0] - 2).to(torch.int64)
    t = torch.clamp(f - i.to(torch.float32), 0.0, 1.0)
    lo = table[i]
    hi = table[i + 1]
    out = lo + t[..., None] * (hi - lo)
    valid = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return torch.where(valid[..., None], out, 0.0)


def spectral_to_xyz(lam: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum_l cmf(lambda_l) * p_l over the hero axis -> [..., 3] (a plain
    sum: hero-MIS weights already account for lane multiplicity)."""
    return torch.sum(xyz_of_lambda(lam) * p[..., None], dim=-2)


def cauchy_from_abbe(n_d: float, v_d: float) -> tuple[float, float]:
    """Cauchy coefficients (A, B[um^2]) from n_d and the Abbe number."""
    if v_d == 0.0:
        return n_d, 0.0
    l_c, l_f, l_d = 0.6563, 0.4861, 0.587561
    c = (l_c * l_c * l_f * l_f) / (l_c * l_c - l_f * l_f)
    b = (n_d - 1.0) / v_d * c
    a = n_d - b / (l_d * l_d)
    return a, b


def eta_from_abbe(n_d: float, v_d: float, lam: torch.Tensor) -> torch.Tensor:
    """Spectral IOR eta(lambda[nm]) via Cauchy's equation."""
    a, b = cauchy_from_abbe(n_d, v_d)
    return a + (b * 1e6) / (lam * lam)


def blackbody(temp: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Planck spectral radiance [W/m^2/sr/nm] at temperature ``temp`` [K]
    and wavelength ``lam`` [nm] in the reference's convention
    (include/vol/shaders.h:24-47), which omits the factor 2 of the
    textbook 2hc^2 numerator; kept so emissive volumes match.  temp <= 0
    emits nothing."""
    h = 6.62606957e-34
    c = 299792458.0
    k = 1.3807e-23
    temp = torch.as_tensor(temp, dtype=torch.float32)
    lam = torch.as_tensor(lam, dtype=torch.float32)
    lam5 = lam ** 5
    c1 = 1e45 * h * c * c / torch.clamp(lam5, min=1e-20)
    t_safe = torch.clamp(temp, min=1.0)
    c2 = (h * c * 1e9 / k) / (lam * t_safe)
    val = c1 / torch.clamp(torch.exp(torch.clamp(c2, max=80.0)) - 1.0,
                           min=1e-30) * 1e-9
    return torch.where(temp > 0.0, val, 0.0)
