"""Image-based environment lighting, a lat-long envmap
(corona13_tpu/models/envmap.py).

Radiance is stored as a lat-long grid of rgb2spec sigmoid coefficients,
fitted at load with ``rgb2spec.fit_coeff`` and evaluated at the path
wavelengths with a bilinear fetch.  Importance sampling uses row and
column CDFs over luminance * sin(theta).  Directions use the reference's
z-up lat-long convention (sky_envmap.c:66-96).

``sample`` searches each lane's own row of ``col_cdf`` by bisection: one
gathered element a lane a step, log2(W) steps.  Gathering the rows
themselves (``col_cdf[row]``, [N, W]) would take gigabytes for a frame's
wavefront over a 2048-wide map.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..spectral import rgb2spec


@dataclasses.dataclass
class EnvMap:
    coeff: torch.Tensor     # [H, W, 3] sigmoid coefficients
    mul: torch.Tensor       # [H, W] brightness multiplier
    lum: torch.Tensor       # [H, W] luminance (importance table)
    row_cdf: torch.Tensor   # [H] marginal CDF over rows (sin-weighted)
    col_cdf: torch.Tensor   # [H, W] conditional CDF per row
    total: torch.Tensor     # 0-d: sum(lum * sin) for the pdf

    @property
    def height(self):
        return self.coeff.shape[0]

    @property
    def width(self):
        return self.coeff.shape[1]


def build(rgb: np.ndarray, device='cuda') -> EnvMap:
    """Fit an EnvMap from a lat-long RGB radiance image [H, W, 3]; the
    coefficient fit runs on ``device`` and the tables stay there."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    mul = np.maximum(rgb.max(axis=-1), 1.0)
    unit = rgb / mul[..., None]
    coeff = rgb2spec.fit_coeff(unit, space='ergb', device=device)
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    weighted = lum * np.sin(theta)[:, None]
    row_sum = weighted.sum(axis=1)
    total = row_sum.sum()
    row_cdf = np.cumsum(row_sum) / max(total, 1e-20)
    col_cdf = np.cumsum(weighted, axis=1) / np.maximum(
        row_sum[:, None], 1e-20)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return EnvMap(coeff=coeff, mul=t(mul), lum=t(lum), row_cdf=t(row_cdf),
                  col_cdf=t(col_cdf), total=t(total))


def _dir_to_uv(d):
    """z-up lat-long: u = atan2 azimuth, v = polar angle."""
    phi = torch.atan2(d[..., 1], d[..., 0])
    u = torch.remainder(phi / (2.0 * math.pi), 1.0)
    v = torch.acos(torch.clamp(d[..., 2], -1.0 + 1e-7, 1.0 - 1e-7)) / math.pi
    return u, v


def _uv_to_dir(u, v):
    phi = 2.0 * math.pi * u
    theta = math.pi * v
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def eval_radiance(env: EnvMap, d, lam):
    """Spectral radiance toward direction d [N,3] at wavelengths lam
    [N,MF] (bilinear over the coefficient grid)."""
    h, w = env.height, env.width
    u, v = _dir_to_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0
    fy = torch.clamp(y - y0, 0.0, 1.0)
    xi0 = torch.remainder(x0, w)
    xi1 = torch.remainder(x0 + 1, w)

    def fetch(yi, xi):
        c = env.coeff[yi, xi]
        m = env.mul[yi, xi]
        return m[..., None] * rgb2spec.eval_coeff(c[..., None, :], lam)

    return (fetch(y0, xi0) * ((1 - fx) * (1 - fy))[..., None]
            + fetch(y0, xi1) * (fx * (1 - fy))[..., None]
            + fetch(y0 + 1, xi0) * ((1 - fx) * fy)[..., None]
            + fetch(y0 + 1, xi1) * (fx * fy)[..., None])


def _search_rows(cdf, row, u):
    """Per lane, the first column whose ``cdf[row, col] >= u`` (what
    ``searchsorted(cdf[row], u, side='left')`` returns, in [0, W]), by
    bisection over each lane's own row: no [N, W] gather, and the keys keep
    all their float32 bits."""
    w = cdf.shape[1]
    flat = cdf.reshape(-1)
    base = row * w
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    for _ in range(w.bit_length()):
        mid = (lo + hi) // 2
        below = flat[base + torch.clamp(mid, max=w - 1)] < u
        open_ = lo < hi
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return lo


def sample(env: EnvMap, r1, r2):
    """Importance-sample a direction by luminance*sin(theta).
    Returns (dir [N,3], pdf_solid_angle [N])."""
    h, w = env.height, env.width
    row = torch.clamp(torch.searchsorted(env.row_cdf, r1.contiguous(),
                                         right=False), 0, h - 1)
    col = torch.clamp(_search_rows(env.col_cdf, row, r2), 0, w - 1)
    # uniform within the texel
    u = (col.to(torch.float32) + 0.5) / w
    v = (row.to(torch.float32) + 0.5) / h
    d = _uv_to_dir(u, v)
    return d, pdf(env, d)


def pdf(env: EnvMap, d):
    """Solid-angle pdf of :func:`sample` for direction d."""
    h, w = env.height, env.width
    u, v = _dir_to_uv(d)
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    theta = (yi.to(torch.float32) + 0.5) / h * math.pi
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    # texel probability / texel solid angle
    p_texel = env.lum[yi, xi] * sin_t / torch.clamp(env.total, min=1e-20)
    omega_texel = (2.0 * math.pi / w) * (math.pi / h) * sin_t
    return p_texel / torch.clamp(omega_texel, min=1e-20)


def make_gradient_sky(top=(0.3, 0.5, 0.9), bottom=(0.8, 0.7, 0.5),
                      sun_dir=None, sun_radiance=50.0, res=(64, 128)):
    """Procedural test envmap (host numpy [H, W, 3]): vertical gradient
    and an optional sun disk."""
    h, w = res
    v = (np.arange(h) + 0.5) / h
    rgb = (np.asarray(top)[None, None] * (1 - v)[:, None, None]
           + np.asarray(bottom)[None, None] * v[:, None, None])
    rgb = np.broadcast_to(rgb, (h, w, 3)).copy()
    if sun_dir is not None:
        sd = np.asarray(sun_dir, np.float32)
        sd = sd / np.linalg.norm(sd)
        uu, vv = np.meshgrid((np.arange(w) + 0.5) / w,
                             (np.arange(h) + 0.5) / h)
        phi = 2 * np.pi * uu
        theta = np.pi * vv
        dirs = np.stack([np.sin(theta) * np.cos(phi),
                         np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
        mask = (dirs @ sd) > 0.995
        rgb[mask] = sun_radiance
    return rgb.astype(np.float32)
