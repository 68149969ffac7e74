# Frozen copy of corona13_tpu_torch/spectral/rgb2spec.py (lines 1-210) as of commit 2084081, for the benchmark's plain reference.
"""Spectral upsampling of RGB reflectances (corona13_tpu/spectral/rgb2spec.py).

The Jakob & Hanika 2019 sigmoid-polynomial
``S(lambda) = s(c0*lambda^2 + c1*lambda + c2)``, ``s(x) = 1/2 + x / (2
sqrt(1 + x^2))``, lambda in nm.  Constant albedos are fitted exactly at
scene load by the same Levenberg-Marquardt 3x3 solve as the JAX package,
in float32, on the device the caller names (``fit_coeff(..., device=...)``
is a required keyword: the scene loader fits its few albedos on the CPU, an
environment map its millions of texels where the scene lives).  Textures
of RGB values can use the trilinear coefficient LUT instead
(:class:`Rgb2SpecLUT`, :func:`fetch_lut`, :func:`build_lut`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.math import rsqrt, sqrt
from . import cie, colour


def eval_coeff(coeff: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Evaluate the sigmoid-polynomial reflectance.

    coeff: [..., 3] (c0, c1, c2); lam: [...] nm (broadcastable against
    coeff minus its last axis)."""
    x = (coeff[..., 0] * lam + coeff[..., 1]) * lam + coeff[..., 2]
    return 0.5 + 0.5 * x * rsqrt(x * x + 1.0)


# dense wavelength grid for projection integrals
_N_QUAD = 95
# normalized wavelength basis for well-conditioned fitting:
# t = (lambda - 550) / 300 keeps coefficients O(1)
_T_CENTER = 550.0
_T_SCALE = 300.0


def _quad_lambdas() -> np.ndarray:
    return np.linspace(cie.LAMBDA_MIN, cie.LAMBDA_MAX, _N_QUAD).astype(np.float32)


def _norm_to_nm(cn: torch.Tensor) -> torch.Tensor:
    """Coefficients in the normalized basis x(t) = c0 t^2 + c1 t + c2,
    t = (lam - C)/S, converted to the nm basis used by eval_coeff."""
    c0, c1, c2 = cn[..., 0], cn[..., 1], cn[..., 2]
    a0 = c0 / (_T_SCALE ** 2)
    a1 = c1 / _T_SCALE - 2.0 * _T_CENTER * c0 / (_T_SCALE ** 2)
    a2 = (c0 * _T_CENTER ** 2 / (_T_SCALE ** 2)
          - c1 * _T_CENTER / _T_SCALE + c2)
    return torch.stack([a0, a1, a2], dim=-1)


# rows fitted at once: bounds the [rows, 95] temporaries of a large image
_FIT_ROWS = 1 << 18


def fit_coeff(rgb, space: str = 'ergb', iters: int = 50, *,
              device) -> torch.Tensor:
    """Fit sigmoid-poly coefficients reproducing ``rgb`` (values in [0,1])
    by Levenberg-Marquardt on the 3x3 system rgb(S(c)) = rgb_target,
    batched over leading axes, in float32 on ``device``; the result stays
    there."""
    target = torch.as_tensor(np.asarray(rgb, np.float32), device=device)
    flat = target.reshape(-1, 3)
    out = torch.cat([_fit_rows(flat[i:i + _FIT_ROWS], space, iters)
                     for i in range(0, max(flat.shape[0], 1), _FIT_ROWS)])
    return out.reshape(target.shape[:-1] + (3,))


def _fit_rows(flat: torch.Tensor, space: str, iters: int) -> torch.Tensor:
    dev = flat.device
    m = torch.as_tensor(colour.from_xyz_matrix(space), device=dev)
    lams = torch.as_tensor(_quad_lambdas(), device=dev)
    t_n = (lams - _T_CENTER) / _T_SCALE
    basis = torch.stack([t_n * t_n, t_n, torch.ones_like(t_n)], dim=-1)  # [Q,3]
    cmf = cie.xyz_of_lambda(lams)                                       # [Q,3]
    norm = torch.sum(cmf[:, 1])
    w = (cmf / norm) @ m.T                                              # [Q,3out]

    def residual(c):                                  # c: [B,3] normalized
        x = c @ basis.T                               # [B,Q]
        s = 0.5 + 0.5 * x * rsqrt(x * x + 1.0)
        xyz = (s @ cmf) / norm                        # [B,3]
        return xyz @ m.T - flat

    def jacobian(c):
        """d residual / d c, [B,3out,3c]: ds/dx = 0.5 (1+x^2)^-3/2."""
        x = c @ basis.T
        dsdx = 0.5 * (x * x + 1.0) ** (-1.5)
        return torch.einsum('bq,qo,qk->bok', dsdx, w, basis)

    mean = torch.clamp(torch.mean(flat, dim=-1), 1e-3, 1.0 - 1e-3)
    x0 = (2.0 * mean - 1.0) / (2.0 * sqrt(mean * (1.0 - mean)))
    c = torch.zeros_like(flat)
    c[:, 2] = x0
    lm = torch.full((flat.shape[0],), 1e-4, device=dev)
    eye = torch.eye(3, device=dev)
    for _ in range(iters):
        j = jacobian(c)
        r = residual(c)
        err = torch.sum(r * r, dim=-1)
        jtj = torch.einsum('bok,bol->bkl', j, j)
        jtr = torch.einsum('bok,bo->bk', j, r)
        a = jtj + lm[:, None, None] * eye
        dp = torch.linalg.solve(a, jtr[..., None])[..., 0]
        c_new = c - dp
        err_new = torch.sum(residual(c_new) ** 2, dim=-1)
        better = err_new < err
        c = torch.where(better[:, None], c_new, c)
        lm = torch.where(better, torch.clamp(lm * 0.3, min=1e-8), lm * 4.0)
    return _norm_to_nm(c)


def fit_coeff_scaled(rgb: np.ndarray, space: str = 'ergb'):
    """Fit arbitrary-brightness rgb: returns numpy (coeff, mul) with
    rgb = mul * rgb_unit, mul >= 1 (colours <= 1 are not scaled).  A host
    helper of the scene loader (a handful of albedos a scene): fitted on
    the CPU."""
    rgb = np.asarray(rgb, np.float32)
    mul = np.maximum(rgb.max(axis=-1), 1.0)
    unit = rgb / mul[..., None]
    coeff = fit_coeff(unit, space=space, device='cpu').numpy()
    return coeff, mul


# --- LUT --------------------------------------------------------------------
