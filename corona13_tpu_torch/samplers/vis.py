"""Debug/AOV render mode (corona13_tpu/samplers/vis.py; corona-13
src/render.d/vis.c): first-hit normals, depth, primitive and material ids
and hit uv, one closest-hit launch a frame."""

from __future__ import annotations

import torch

from ..models import camera as camera_mod
from ..models import shading as shading_mod
from ..ops import rng
from ..ops.trace import intersect
from ..spectral import cie
from .pt import PTConfig

KINDS = ('normals', 'depth', 'prim', 'shader', 'uv')


def _id_colour(ids):
    """Three hashed channels of an id: uint32 products mod 255, carried in
    int64 and masked to 32 bits as ``ops/rng.py`` does."""
    p = ids.to(torch.int64) & rng.M32
    return torch.stack([((p * m) & rng.M32) % 255 for m in
                        (2654435761, 40503, 9973)], dim=-1).to(
                            torch.float32) / 255.0


def render_aov(scene, cfg: PTConfig, sample_idx, kind: str = 'normals'):
    """Render one AOV sample per pixel: kind in ('normals', 'depth',
    'prim', 'shader', 'uv').  Returns [H, W, 3]."""
    if kind not in KINDS:
        raise ValueError(kind)
    n = cfg.width * cfg.height
    dev = scene.device
    pixel_idx = torch.arange(n, dtype=torch.int64, device=dev)

    def rnd(dim):
        return rng.sample_dim(cfg.pointsampler, pixel_idx, sample_idx,
                              int(dim), cfg.seed)

    pix_i = (pixel_idx % cfg.width).to(torch.float32) + rnd(rng.Dim.IMAGE_X)
    pix_j = (pixel_idx // cfg.width).to(torch.float32) + rnd(rng.Dim.IMAGE_Y)
    lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), cfg.mf)
    org, d, _, _ = camera_mod.sample(
        scene.camera, cfg.width, cfg.height, pix_i, pix_j,
        rnd(rng.Dim.APERTURE_X), rnd(rng.Dim.APERTURE_Y),
        torch.zeros(n, dtype=torch.float32, device=dev))
    hit = intersect(scene.geom, org, d)
    x = org + torch.where(hit.valid, hit.t, 0.0)[..., None] * d

    if kind == 'normals':
        col = 0.5 * (shading_mod.prepare(scene, hit, x, d, lam).n + 1.0)
    elif kind == 'depth':
        z = torch.where(hit.valid, hit.t, 0.0)
        col = (z / torch.clamp(torch.amax(z), min=1e-20))[..., None].expand(
            n, 3)
    elif kind == 'prim':
        col = _id_colour(torch.clamp(hit.prim, min=0))
    elif kind == 'shader':
        col = _id_colour(scene.prim_shader[torch.clamp(hit.prim, min=0)])
    else:
        col = torch.stack([hit.u, hit.v, torch.zeros_like(hit.u)], dim=-1)
    col = torch.where(hit.valid[..., None], col, 0.0)
    return col.reshape(cfg.height, cfg.width, 3)
