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

On CPU tensors the scatters sort their taps (``_scatter_sorted``); on CUDA
tensors they go through the binned sum of ``ops/splat_cuda.py``, the same
bits with no global sort, and ``splat`` with a 4x4 filter forms its taps
in that chain too (``_FootprintSplat``).
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from ..utils.math import sqrt
from . import splat_cuda


def cubic_bspline(x):
    """Cubic B-spline kernel, support [-2, 2]."""
    a = torch.abs(x)
    near = 2.0 / 3.0 - a * a + 0.5 * a * a * a
    far = ((2.0 - a) ** 3) / 6.0
    return torch.where(a < 1.0, near, torch.where(a < 2.0, far, 0.0))


def gaussian_window(r, sigma=0.7):
    """Truncated gaussian."""
    return torch.where(r <= 2.5, torch.exp(-0.5 * (r / sigma) ** 2), 0.0)


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


def _bits(x):
    """The float32 bit pattern of x as int64 in [-2^31, 2^31)."""
    return x.contiguous().view(torch.int32).to(torch.int64)


def _scatter(fb, yi, xi, contrib, keep=None):
    """fb [..., H, W, 3] flattened over its leading axes plus a scatter-add
    of contrib [..., 3] at flat pixel indices (yi * W + xi, with any cascade
    level folded into yi by the caller); out of place.  Where ``keep`` is
    False the contribution is left out (a filter tap off the image, whose
    weight is 0).  Reproducible: ``_scatter_sorted``'s bits, on CUDA
    tensors through the binned sum of ``ops/splat_cuda.py``."""
    if fb.is_cuda:
        flat = (yi * fb.shape[-2] + xi).reshape(-1)
        return _BinnedScatter.apply(
            fb, flat, None if keep is None else keep.reshape(-1), contrib)
    return _scatter_sorted(fb, yi, xi, contrib, keep)


def _scatter_sorted(fb, yi, xi, contrib, keep=None):
    """``_scatter`` by sorting, on any device: the contributions are sorted
    by (pixel, then the bits of their three colours), an order that does
    not depend on the order of the input, and each pixel's run is summed
    serially in that order (``segment_reduce``), so the same splats give
    the same bits on every run and under any permutation.  An atomic
    ``index_add`` sums in no fixed order on the card.  The left-out taps
    sort past the last pixel and are never summed: clamped to the border,
    the taps of every splat off the film would make one pixel's run, and
    its serial sum, as long as their count."""
    w = fb.shape[-2]
    n_pix = fb.numel() // 3
    flat = _landing((yi * w + xi).reshape(-1),
                    None if keep is None else keep.reshape(-1), n_pix)
    vals = contrib.reshape(-1, 3)
    if tracing.counting_on():
        summed = _adds(flat, vals, n_pix)
        tracing.count_splat(summed.sum(), summed.numel())
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


def _landing(flat, keep, n_pix):
    """Each tap's flat pixel [M], or n_pix where the tap is left out:
    ``keep`` [M] False (for a 4x4 filter, ``_footprint``'s mask) or the
    pixel outside the film.  The one rule for which taps a scatter may
    sum, shared by the sort path, its counter and the gradients;
    ``csrc/splat_general.cu`` keeps a copy in ``footprint`` and
    ``given``."""
    ok = (flat >= 0) & (flat < n_pix)
    if keep is not None:
        ok = ok & keep
    return torch.where(ok, flat, n_pix)


def _adds(landing, vals, n_pix):
    """The taps that add something [M]: those ``_landing`` puts on the
    film, unless all three colours of vals [M, 3] are +-0.0 (the taps the
    card's binned sum keeps; dropping the others leaves the sum's bits)."""
    return (landing < n_pix) & (vals != 0.0).any(-1)


def _scatter_grad(g, flat, keep):
    """The gradient of ``_scatter`` in contrib [M, 3] from the output's,
    g [..., 3]: each tap ``_landing`` keeps gathers its pixel's."""
    g = g.reshape(-1, 3)
    n_pix = g.shape[0]
    at = _landing(flat, keep, n_pix)
    return torch.where((at < n_pix)[:, None], g[at.clamp(max=n_pix - 1)], 0.0)


class _BinnedScatter(torch.autograd.Function):
    """``splat_cuda.scatter`` with ``_scatter``'s gradient: contrib's from
    ``_scatter_grad``, fb's passed through."""

    @staticmethod
    def forward(ctx, fb, flat, keep, contrib):
        ctx.save_for_backward(flat, keep)
        ctx.shape = contrib.shape
        return splat_cuda.scatter(fb.contiguous(), flat, keep,
                                  contrib.reshape(-1, 3).contiguous())

    @staticmethod
    def backward(ctx, g):
        flat, keep = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[3]:
            grad = _scatter_grad(g, flat, keep).reshape(ctx.shape)
        return g, None, None, grad


N_DBOR = 8  # cascade buffers (reference --dbor default count)


def splat_dbor(fbs, pix_i, pix_j, col):
    """Density-based outlier rejection cascade (corona-13 view.c:497-522 +
    include/dbor.h): a splat with luminance L lands in the log2 cascade at
    k = log2(L), split linearly between buffers floor(k) and ceil(k) so
    each buffer holds a trust-banded portion of the image.

    fbs: [N_DBOR, H, W, 3]; returns the updated cascade."""
    for t in _dbor_taps(fbs.shape[1], fbs.shape[2], pix_i, pix_j, col):
        fbs = _scatter(fbs, *t)
    return fbs


def _dbor_taps(h, w, pix_i, pix_j, col):
    """``splat_dbor``'s two scatters, (yi, xi, contrib, keep) each, the
    cascade level folded into yi."""
    lum = torch.clamp(col[..., 1], min=1e-20)
    # clamp *values* into the top bucket's level so a firefly cannot
    # masquerade as many samples of the bucket's nominal brightness
    k = torch.clamp(torch.log2(lum), 0.0, N_DBOR - 1 - 1e-4)
    k0 = torch.floor(k).to(torch.int64)
    w1 = k - k0
    xi = torch.clamp(pix_i.to(torch.int64), 0, w - 1)
    yi = torch.clamp(pix_j.to(torch.int64), 0, h - 1)
    k1 = torch.clamp(k0 + 1, max=N_DBOR - 1)
    return [(k0 * h + yi, xi, col * (1.0 - w1)[..., None], None),
            (k1 * h + yi, xi, col * w1[..., None], None)]


def dbor_merge(fbs, trust: float = 4.0):
    """Reassemble the cascade (tools/img/dbor.c): buffer k contributes
    fully where its local sample density reaches ``trust`` samples (count
    approximated from the accumulated luminance over the bucket's nominal
    level 2^k, averaged over a 3x3 neighbourhood); rare high-energy splats
    (fireflies) are attenuated proportionally."""
    out = torch.zeros_like(fbs[0])
    for k in range(N_DBOR):
        lum = fbs[k][..., 1]
        count = lum / (2.0 ** k)
        cpad = torch.nn.functional.pad(count, (1, 1, 1, 1))
        nb = sum(cpad[1 + dy: cpad.shape[0] - 1 + dy,
                      1 + dx: cpad.shape[1] - 1 + dx]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
        t = torch.clamp(nb / trust, 0.0, 1.0) if k > 0 \
            else torch.ones_like(lum)
        out = out + fbs[k] * t[..., None]
    return out


def splat(fb, pix_i, pix_j, col, filter_kind: str = 'blackmanharris'):
    """Accumulate colours into fb [H, W, 3], inside the span
    ``splat.general``.

    pix_i/pix_j: continuous image coordinates [N]; col: [N, 3].
    Returns the updated framebuffer."""
    with tracing.span('splat.general'):
        return _splat(fb, pix_i, pix_j, col, filter_kind)


def _splat(fb, pix_i, pix_j, col, filter_kind):
    h, w = fb.shape[0], fb.shape[1]
    if fb.is_cuda and filter_kind not in ('box', 'bilin'):
        if torch.is_grad_enabled() and (pix_i.requires_grad
                                        or pix_j.requires_grad):
            raise NotImplementedError(
                'splat: the card has no gradient in pix_i or pix_j')
        return _FootprintSplat.apply(fb, pix_i, pix_j, col, filter_kind)
    for t in _taps(h, w, pix_i, pix_j, col, filter_kind):
        fb = _scatter(fb, *t)
    return fb


def _taps(h, w, pix_i, pix_j, col, filter_kind):
    """The plain path's scatters of ``splat``, in order: (yi, xi, contrib,
    keep) each, rows and columns clamped to the film.  bilin is four
    scatters, one a corner; the others one."""
    if filter_kind == 'box':
        xi = torch.clamp(pix_i.to(torch.int64), 0, w - 1)
        yi = torch.clamp(pix_j.to(torch.int64), 0, h - 1)
        return [(yi, xi, col, None)]

    if filter_kind == 'bilin':
        x = pix_i - 0.5
        y = pix_j - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = x - x0
        fy = y - y0
        out = []
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                xi = x0 + dx
                yi = y0 + dy
                inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                out.append((torch.clamp(yi, 0, h - 1),
                            torch.clamp(xi, 0, w - 1),
                            torch.where(inb[..., None],
                                        wgt[..., None] * col, 0.0), inb))
        return out

    f, yi, xi, keep = _footprint(h, w, pix_i, pix_j, filter_kind)
    return [(yi, xi, f[..., None] * col[..., None, None, :], keep)]


def _footprint(h, w, pix_i, pix_j, filter_kind):
    """The 4x4 filters' 16 taps a splat: weights f [N, 4v, 4u] normalized
    over the in-bounds taps, their rows and columns clamped to the film,
    and the mask of the taps kept: in bounds, of a splat whose coordinates
    are finite (the card's footprint keeps the same taps)."""
    dev = pix_i.device
    x0 = torch.floor(pix_i - 1.5).to(torch.int64)
    y0 = torch.floor(pix_j - 1.5).to(torch.int64)
    taps = torch.arange(4, device=dev)
    uu = (x0[..., None] + taps + 0.5) - pix_i[..., None]          # [N, 4]
    vv = (y0[..., None] + taps + 0.5) - pix_j[..., None]          # [N, 4]
    if filter_kind == 'spline':
        f = cubic_bspline(vv)[..., :, None] * cubic_bspline(uu)[..., None, :]
    else:
        r = sqrt(uu[..., None, :] ** 2 + vv[..., :, None] ** 2)
        f = gaussian_window(r) if filter_kind == 'gaussian' \
            else bh_window(r + 1.5)                               # [N, 4v, 4u]
    xi = (x0[..., None, None] + taps[None, None, :]).expand(f.shape)
    yi = (y0[..., None, None] + taps[None, :, None]).expand(f.shape)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    f = torch.where(inb, f, 0.0)
    # normalize over in-bounds taps (the reference normalizes per splat)
    norm = torch.sum(f, dim=(-1, -2), keepdim=True)
    f = f / torch.clamp(norm, min=1e-20)
    keep = inb & (torch.isfinite(pix_i) & torch.isfinite(pix_j))[..., None,
                                                                   None]
    return f, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1), keep


def _footprint_grad(g, pix_i, pix_j, filter_kind):
    """The gradient of the 4x4 splat in col [N, 3] from the framebuffer's,
    g [H, W, 3]: each splat's normalized weights times its taps' pixels'
    gradients, over the taps ``_footprint`` keeps."""
    h, w = g.shape[0], g.shape[1]
    f, yi, xi, keep = _footprint(h, w, pix_i, pix_j, filter_kind)
    taps = g.reshape(-1, 3)[(yi * w + xi).reshape(-1)].reshape(*f.shape, 3)
    return torch.where(keep[..., None], taps * f[..., None],
                       0.0).sum(dim=(-3, -2))


class _FootprintSplat(torch.autograd.Function):
    """``splat_cuda.footprint`` with the 4x4 splat's gradient in col
    (``_footprint_grad``), fb's passed through; none in pix_i, pix_j."""

    @staticmethod
    def forward(ctx, fb, pix_i, pix_j, col, filter_kind):
        ctx.save_for_backward(pix_i, pix_j)
        ctx.filter_kind = filter_kind
        return splat_cuda.footprint(fb.contiguous(), pix_i.contiguous(),
                                    pix_j.contiguous(), col.contiguous(),
                                    filter_kind)

    @staticmethod
    def backward(ctx, g):
        pix_i, pix_j = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[3]:
            grad = _footprint_grad(g, pix_i, pix_j, ctx.filter_kind)
        return g, None, None, grad, None
