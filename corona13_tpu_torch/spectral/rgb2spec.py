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

import struct

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

class Rgb2SpecLUT:
    """Coefficient LUT in the reference's layout: data[i, z, y, x, 3] where
    i = argmax component, (x, y) = the other two components scaled by the
    max, z = the max component's value on the (possibly non-uniform)
    ``scale`` grid.  Host numpy; ``fetch_lut`` takes tensors of it."""

    def __init__(self, res: int, scale: np.ndarray, data: np.ndarray):
        self.res = int(res)
        self.scale = np.asarray(scale, np.float32)
        self.data = np.asarray(data, np.float32).reshape(3, res, res, res, 3)

    @classmethod
    def load(cls, path: str) -> 'Rgb2SpecLUT':
        """Read the reference's binary 'SPEC' format (rgb2spec.h:27-63)."""
        with open(path, 'rb') as f:
            if f.read(4) != b'SPEC':
                raise ValueError(f'{path}: not a SPEC coefficient file')
            (res,) = struct.unpack('<I', f.read(4))
            scale = np.frombuffer(f.read(4 * res), np.float32)
            data = np.frombuffer(f.read(4 * res ** 3 * 9), np.float32)
        return cls(res, scale, data)

    def save(self, path: str) -> None:
        with open(path, 'wb') as f:
            f.write(b'SPEC')
            f.write(struct.pack('<I', self.res))
            f.write(self.scale.astype('<f4').tobytes())
            f.write(self.data.astype('<f4').tobytes())


def fetch_lut(lut_scale: torch.Tensor, lut_data: torch.Tensor,
              rgb: torch.Tensor) -> torch.Tensor:
    """Trilinear LUT fetch.  lut_data: [3, res, res, res, 3]; rgb: [..., 3]
    in [0,1]; returns coefficients [..., 3] (reference rgb2spec_fetch)."""
    res = lut_data.shape[1]
    i = torch.argmax(rgb, dim=-1)
    comp = lambda k: torch.gather(rgb, -1, (k % 3)[..., None])[..., 0]
    z = comp(i)
    zsafe = torch.clamp(z, min=1e-10)
    x = comp(i + 1) * (res - 1) / zsafe
    y = comp(i + 2) * (res - 1) / zsafe
    xi = torch.clamp(x.to(torch.int64), 0, res - 2)
    yi = torch.clamp(y.to(torch.int64), 0, res - 2)
    zi = torch.clamp(torch.searchsorted(lut_scale, z.contiguous(), right=True)
                     - 1, 0, res - 2)
    x1 = (x - xi)[..., None]
    y1 = (y - yi)[..., None]
    z1 = ((z - lut_scale[zi]) / (lut_scale[zi + 1] - lut_scale[zi]))[..., None]
    x0, y0, z0 = 1.0 - x1, 1.0 - y1, 1.0 - z1

    def g(dz, dy, dx):
        return lut_data[i, zi + dz, yi + dy, xi + dx]

    return (((g(0, 0, 0) * x0 + g(0, 0, 1) * x1) * y0 +
             (g(0, 1, 0) * x0 + g(0, 1, 1) * x1) * y1) * z0 +
            ((g(1, 0, 0) * x0 + g(1, 0, 1) * x1) * y0 +
             (g(1, 1, 0) * x0 + g(1, 1, 1) * x1) * y1) * z1)


def build_lut(res: int = 32, space: str = 'ergb', *,
              device) -> Rgb2SpecLUT:
    """Generate a coefficient LUT by fitting every grid point on ``device``
    (the reference builds it offline with tools/img/rgb2spec_opt.cpp); the
    LUT itself is host numpy."""
    # smoothstep-warped z grid concentrates resolution near the gamut edges
    t = np.linspace(0, 1, res, dtype=np.float32)
    scale = t * t * (3 - 2 * t)
    scale[0] = 1e-4  # avoid the degenerate black corner
    xs = np.arange(res, dtype=np.float32) / (res - 1)
    rgb = np.zeros((3, res, res, res, 3), np.float32)
    for i in range(3):
        for zi in range(res):
            z = scale[zi]
            xg, yg = np.meshgrid(xs * z, xs * z, indexing='xy')
            rgb[i, zi, ..., i] = z
            rgb[i, zi, ..., (i + 1) % 3] = xg
            rgb[i, zi, ..., (i + 2) % 3] = yg
    data = fit_coeff(rgb, space=space, device=device).cpu().numpy()
    return Rgb2SpecLUT(res, scale, data.reshape(-1))
