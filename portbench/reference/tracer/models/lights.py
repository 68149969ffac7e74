# Frozen copy of corona13_tpu_torch/models/lights.py (lines 1-111) as of commit 2084081, for the benchmark's plain reference.
"""Emitter sampling and evaluation (corona13_tpu/models/lights.py).

Emissive prims are importance-sampled by area*L with a flat CDF; the NEE
vertex-area pdf of a prim is L/sum(L*A), and geometric emitters carry a
Phong EDF driven by shading roughness.  Emission is one-sided along the
geometric normal.
"""

from __future__ import annotations

import math

import torch

from ..utils.math import cross, dot, normalize, sqrt


def phong_edf(roughness, cos_gn):
    """EDF lobe value for the outgoing cosine against the geometric normal
    (power base clamped away from 0 like the JAX package)."""
    diffuse = roughness > 1.0 - 1e-4
    r2 = torch.clamp(roughness * roughness, min=1e-8)
    k = 2.0 / r2 - 2.0
    glossy = (torch.pow(torch.clamp(cos_gn, min=1e-6), k) * (k + 2.0)
              / (2.0 * math.pi)) * (cos_gn > 0.0)
    return torch.where(diffuse, 1.0 / math.pi, glossy)


def eval_vertex(em, roughness, gn, omega_in):
    """Emitted radiance toward -omega_in for a path-traced emitter hit
    (one-sided: only where dot(gn, omega_in) < 0)."""
    cos_gn = -dot(gn, omega_in)
    edf = phong_edf(roughness, cos_gn)
    ok = (cos_gn > 0.0) & torch.isfinite(edf)
    edf = torch.where(ok, edf, 0.0)
    return em * edf[..., None]


def sky_eval(scene, direction, lam):
    """Environment radiance for escaped rays: a black or constant sky
    (the benchmark's scenes have no envmap or daylight sky).
    direction: [N, 3]; lam: [N, MF]."""
    from ..spectral import rgb2spec
    base = scene.sky_mul * rgb2spec.eval_coeff(scene.sky_coeff[None, None, :],
                                               lam)
    return torch.where(scene.sky_kind > 0, base, 0.0)


def sample_nee(lights, geom, from_pos, r1, r2, r3):
    """Sample a point on an emissive triangle.

    Returns dict with pos, gn (geometric normal), prim (global id),
    pdf_area (= L/sum(L*A)), u, v."""
    k = torch.clamp(torch.searchsorted(lights.cdf, r1, right=False), 0,
                    lights.n_lights - 1)
    prim = lights.prim[k]
    pdf_area = lights.weight[k]
    v0 = geom.tri_v0[prim]
    e1 = geom.tri_e1[prim]
    e2 = geom.tri_e2[prim]
    a = sqrt(r2)
    u = r3 * a          # weight of vertex 2 (reference hit->u)
    v = (1.0 - r3) * a  # weight of vertex 1 (reference hit->v)
    pos = v0 + v[..., None] * e1 + u[..., None] * e2
    gn = normalize(cross(e1, e2))
    return {'pos': pos, 'gn': gn, 'prim': prim, 'pdf_area': pdf_area,
            'u': u, 'v': v}


def nee_pdf_area(lights, prim):
    """Vertex-area NEE pdf of having sampled global prim ``prim``
    (L/sum(L*A)); 0 for non-emissive prims."""
    p = torch.clamp(prim, min=0)
    w = lights.prim_weight[torch.clamp(p, max=lights.prim_weight.shape[0] - 1)]
    return torch.where(prim >= 0, w, 0.0)
