# Frozen copy of corona13_tpu_torch/ops/splat.py (lines 87-127: _bits, _scatter; lines 174-226: splat, cut to its default Blackman-Harris filter) as of commit 9ac2600, for the benchmark's plain reference of bdpt.
"""The general splat, for samples anywhere on the image
(corona13_tpu/ops/splat.py): one reproducible segmented sum over a flat
pixel index, the same bits on every run and under any order of the
samples.  Only the default radial 4-term Blackman-Harris filter, the
filter the benchmark's cells splat with."""

from __future__ import annotations

import torch

from ..utils.math import sqrt
from .splat import bh_window


def _bits(x):
    """The float32 bit pattern of x as int64 in [-2^31, 2^31)."""
    return x.contiguous().view(torch.int32).to(torch.int64)


def _scatter(fb, yi, xi, contrib, keep=None):
    """fb [..., H, W, 3] flattened over its leading axes plus a scatter-add
    of contrib [..., 3] at flat pixel indices (yi * W + xi, with any cascade
    level folded into yi by the caller); out of place.  Where ``keep`` is
    False the contribution is left out (a filter tap off the image, whose
    weight is 0).

    Reproducible: the contributions are sorted by (pixel, then the bits of
    their three colours), an order that does not depend on the order of
    the input, and each pixel's run is summed serially in that order
    (``segment_reduce``), so the same splats give the same bits on every
    run and under any permutation.  An atomic ``index_add`` sums in no
    fixed order on the card.  The left-out taps sort past the last pixel
    and are never summed: clamped to the border, the taps of every splat
    off the film would make one pixel's run, and its serial sum, as long
    as their count."""
    w = fb.shape[-2]
    n_pix = fb.numel() // 3
    flat = (yi * w + xi).reshape(-1)
    if keep is not None:
        flat = torch.where(keep.reshape(-1), flat, n_pix)
    vals = contrib.reshape(-1, 3)
    key = _bits(vals.detach())
    # two stable sorts: the minor key (colours 1 and 2) first, then the
    # major (pixel, colour 0); each key fits int64 without overflow
    minor = key[:, 1] * (1 << 32) + (key[:, 2] & 0xFFFFFFFF)
    perm = torch.sort(minor, stable=True).indices
    major = flat[perm] * (1 << 32) + (key[perm, 0] & 0xFFFFFFFF)
    major, order = torch.sort(major, stable=True)
    perm = perm[order]
    # each pixel's run [offsets[p], offsets[p + 1]), empty runs sum to 0
    pixels = torch.arange(n_pix + 1, dtype=torch.int64, device=flat.device)
    offsets = torch.searchsorted(major >> 32, pixels)
    sums = torch.segment_reduce(vals[perm], 'sum', offsets=offsets, axis=0,
                                unsafe=True)
    return (fb.reshape(-1, 3) + sums).reshape(fb.shape)


def splat(fb, pix_i, pix_j, col, filter_kind: str = 'blackmanharris'):
    """Accumulate colours into fb [H, W, 3].

    pix_i/pix_j: continuous image coordinates [N]; col: [N, 3].
    Returns the updated framebuffer."""
    if filter_kind != 'blackmanharris':
        raise ValueError(f'the reference splats with blackmanharris only, '
                         f'not {filter_kind!r}')
    h, w = fb.shape[0], fb.shape[1]
    dev = fb.device
    # 4x4 footprint: the 16 taps computed densely, then one scatter
    x0 = torch.floor(pix_i - 1.5).to(torch.int64)
    y0 = torch.floor(pix_j - 1.5).to(torch.int64)
    taps = torch.arange(4, device=dev)
    uu = (x0[..., None] + taps + 0.5) - pix_i[..., None]          # [N, 4]
    vv = (y0[..., None] + taps + 0.5) - pix_j[..., None]          # [N, 4]
    r = sqrt(uu[..., None, :] ** 2 + vv[..., :, None] ** 2)
    f = bh_window(r + 1.5)                                        # [N, 4v, 4u]
    xi = (x0[..., None, None] + taps[None, None, :]).expand(f.shape)
    yi = (y0[..., None, None] + taps[None, :, None]).expand(f.shape)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    f = torch.where(inb, f, 0.0)
    # normalize over in-bounds taps (the reference normalizes per splat)
    norm = torch.sum(f, dim=(-1, -2), keepdim=True)
    f = f / torch.clamp(norm, min=1e-20)
    contrib = f[..., None] * col[..., None, None, :]
    return _scatter(fb, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1),
                    contrib, inb)
