# Frozen copy of corona13_tpu_torch/models/lights.py (lines 77-103: sample_emission) and utils/math.py (lines 106-114: sample_cos_hemisphere) as of commit 9ac2600, for the benchmark's plain reference of bdpt.
"""The start of a light subpath (corona13_tpu/models/lights.py)."""

from __future__ import annotations

import math

import torch

from ..utils.math import build_onb, from_frame, sqrt
from .lights import phong_edf, sample_nee


def sample_cos_hemisphere(r1, r2):
    """Cosine-weighted hemisphere sample in the local frame (z up).
    Returns (dir [..., 3], pdf = cos/pi)."""
    phi = 2.0 * math.pi * r1
    sr = sqrt(r2)
    z = sqrt(torch.clamp(1.0 - r2, min=0.0))
    d = torch.stack([sr * torch.cos(phi), sr * torch.sin(phi), z], dim=-1)
    return d, z / math.pi


def sample_emission(lights, geom, materials, prim_shader, lam,
                    r1, r2, r3, r4, r5):
    """Start a light subpath: pick an emissive prim by the area*L CDF, a
    uniform point on it and a cosine (diffuse-EDF) direction about its
    geometric normal.

    Returns dict(pos, gn, dir, prim, thr [N, MF], pdf_pos, le) with
    thr = Le * cos / (pdf_pos * pdf_dir), the light vertex's throughput."""
    from ..spectral import rgb2spec
    ls = sample_nee(lights, geom, None, r1, r2, r3)
    pos, gn, prim = ls['pos'], ls['gn'], ls['prim']
    pdf_pos = ls['pdf_area']                     # L / sum(L*A)
    mat = prim_shader[torch.clamp(prim, min=0)]
    em = (materials.e_mul[mat, None]
          * rgb2spec.eval_coeff(materials.e_coeff[mat][..., None, :], lam))
    d_local, pdf_dir_cos = sample_cos_hemisphere(r4, r5)
    u, v = build_onb(gn)
    wo = from_frame(u, v, gn, d_local)
    cos_t = d_local[..., 2]
    edf = phong_edf(materials.roughness[mat], cos_t)
    le = em * edf[..., None]
    pdf_pos_safe = torch.where(pdf_pos > 0.0, pdf_pos, 1.0)
    thr = le * (cos_t / (pdf_pos_safe
                         * torch.clamp(pdf_dir_cos, min=1e-12)))[..., None]
    thr = torch.where(torch.isfinite(thr), thr, 0.0)
    return dict(pos=pos, gn=gn, dir=wo, prim=prim, thr=thr, pdf_pos=pdf_pos,
                le=le)
