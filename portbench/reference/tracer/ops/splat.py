# Frozen copy of corona13_tpu_torch/ops/splat.py (lines 1-226) as of commit 2084081, for the benchmark's plain reference.
"""Framebuffer splatting (corona13_tpu/ops/splat.py).

``splat_pixel_aligned``: the progressive renderer traces one path per
pixel per progression, so every splat lands within a fixed 5x5
neighbourhood of its own pixel and the filtered accumulation is 25 shifted
dense adds.  ``splat``: the general form for samples anywhere on the image,
one reproducible segmented sum over a flat pixel index (the same bits on
every run and under any order of the samples; differentiable in ``col``).
Filters of both: box, bilin, spline, gaussian and the default radial 4-term
Blackman-Harris, each normalized per splat over its in-bounds taps.
``splat_dbor`` / ``dbor_merge``: the density-based outlier rejection
cascade.
"""

from __future__ import annotations

import math

import torch

from ..utils.math import sqrt


def bh_window(n):
    """4-term Blackman-Harris window on [0, 3]."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    x = 2.0 * math.pi * n / 3.0
    w = a0 - a1 * torch.cos(x) + a2 * torch.cos(2 * x) - a3 * torch.cos(3 * x)
    return torch.where((n < 0.0) | (n > 3.0), 0.0, w)


def splat_pixel_aligned(fb, jx, jy, col, batch: int = 1,
                        filter_kind: str = 'blackmanharris'):
    """Dense stencil splat.  fb: [H, W, 3]; jx/jy: [batch*H*W] subpixel
    jitters in [0,1); col: [batch*H*W, 3] colours."""
    h, w = fb.shape[0], fb.shape[1]
    if filter_kind == 'box':
        return fb + torch.sum(col.reshape(batch, h, w, 3), dim=0)
    dev = fb.device
    offs = torch.arange(-2, 3, dtype=torch.float32, device=dev)
    du = offs[None, :] + 0.5 - jx[:, None]                 # [N, 5]
    dv = offs[None, :] + 0.5 - jy[:, None]
    if filter_kind == 'bilin':
        fu = torch.clamp(1.0 - torch.abs(du), min=0.0)
        fv = torch.clamp(1.0 - torch.abs(dv), min=0.0)
        f = fv[:, :, None] * fu[:, None, :]                # [N, 5, 5]
    elif filter_kind == 'spline':
        f = cubic_bspline(dv)[:, :, None] * cubic_bspline(du)[:, None, :]
    elif filter_kind == 'gaussian':
        f = gaussian_window(sqrt(du[:, None, :] ** 2 + dv[:, :, None] ** 2))
    else:
        f = bh_window(sqrt(du[:, None, :] ** 2 + dv[:, :, None] ** 2)
                      + 1.5)
    f = f.reshape(batch, h, w, 5, 5)
    ys = torch.arange(h, device=dev)[:, None, None, None]
    xs = torch.arange(w, device=dev)[None, :, None, None]
    oy = torch.arange(-2, 3, device=dev)[None, None, :, None]
    ox = torch.arange(-2, 3, device=dev)[None, None, None, :]
    inb = (ys + oy >= 0) & (ys + oy < h) & (xs + ox >= 0) & (xs + ox < w)
    f = f * inb[None]
    wsum = torch.sum(f, dim=(-1, -2), keepdim=True)
    f = f / torch.clamp(wsum, min=1e-20)
    contrib = (f[..., None] * col.reshape(batch, h, w, 1, 1, 3)).sum(dim=0)
    acc = torch.zeros((h, w, 3), dtype=fb.dtype, device=dev)
    for iy in range(5):
        for ix in range(5):
            sy, sx = iy - 2, ix - 2
            acc[max(sy, 0): h + min(sy, 0), max(sx, 0): w + min(sx, 0)] += \
                contrib[max(-sy, 0): h - max(sy, 0),
                        max(-sx, 0): w - max(sx, 0), iy, ix]
    return fb + acc


N_DBOR = 8  # cascade buffers (reference --dbor default count)

