# Frozen copy of corona13_tpu_torch/models/shading.py (lines 1-189) as of commit 2084081, for the benchmark's plain reference.
"""Hit-point shading preparation (corona13_tpu/models/shading.py).

Given a Hit wavefront: gather the primitive data, compute geometric and
shading normals and texture coordinates, fetch the material row and
evaluate all spectral slots at the path wavelengths.  Triangles are
shaded (the reference covers untextured triangle scenes).  Moving prims
are shaded from their shutter-open data, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..spectral import fresnel_data, rgb2spec
from ..utils.math import build_onb, cross, normalize
from .bsdf import ShadingPoint


def _tri_geo(geom, slot, u, v):
    """Geometric + shading normal, st coords and material id of triangle
    hits, read from the leaf-major rows by the hit's slot
    (slot = leaf_id*8 + row, as the traversal kernel returns it).

    For quad halves (u, v) are remapped to the sub-triangle barycentrics:
    half 1 stores (u, v+u) -> (u, v); half 2 stores (u+v, v) -> (u-v, v)."""
    sl = torch.clamp(slot, min=0)
    rows = geom.tri_bvh.leaf_data[sl]     # [N, 9]  v0, e1, e2
    shade = geom.tri_bvh.leaf_shade[sl]   # [N, 17] vn9, uv6, shader, half
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    gn = normalize(cross(e1, e2))
    half = shade[..., 16].to(torch.int64)
    bu = torch.where(half == 2, u - v, u)   # weight of corner 2
    bv = torch.where(half == 1, v - u, v)   # weight of corner 1
    w0 = 1.0 - bu - bv
    vn = shade[..., 0:9].reshape(shade.shape[:-1] + (3, 3))
    n = normalize(w0[..., None] * vn[..., 0, :] + bv[..., None] * vn[..., 1, :]
                  + bu[..., None] * vn[..., 2, :])
    uvs = shade[..., 9:15].reshape(shade.shape[:-1] + (3, 2))
    st = (w0[..., None] * uvs[..., 0, :] + bv[..., None] * uvs[..., 1, :]
          + bu[..., None] * uvs[..., 2, :])
    # no-uv convention: every corner (0,0) -> fall back to the raw (u, v)
    has_uv = torch.any((torch.abs(uvs) > 0.0).flatten(-2), dim=-1)
    st = torch.where(has_uv[..., None], st, torch.stack([u, v], dim=-1))
    mat = shade[..., 15].to(torch.int64)
    return gn, n, st, mat


def checker_albedo(spectra, st, lam):
    """IT8 chart reflectance from texture coords at wavelengths lam:
    14x10 patches with a 10% flat-grey border grid."""
    u = st[..., 0]
    v = st[..., 1]
    i = torch.remainder((14.0 * u).to(torch.int64), 14)
    j = torch.remainder((10.0 * v).to(torch.int64), 10)
    fu = torch.remainder(14.0 * u, 1.0)
    fv = torch.remainder(10.0 * v, 1.0)
    border = (fu < 0.1) | (fu > 0.9) | (fv < 0.1) | (fv > 0.9)
    patch = 14 * j + i
    li = ((lam - 380.0) / 10.0).to(torch.int64)
    valid = (li >= 0) & (li < 36)
    li = torch.clamp(li, 0, 35)
    val = spectra[patch[..., None], li]
    val = torch.where(valid, val, 0.0)
    return torch.where(border[..., None], 0.3, val)


def prepare(scene, hit, x, wi, lam) -> ShadingPoint:
    """Build the ShadingPoint wavefront for hits.

    x: hit positions [N,3]; wi: propagation direction into the vertex;
    lam: [N, MF] wavelengths.  Invalid hits get absorbing defaults."""
    geom = scene.geom
    gn, n, st, mat = _tri_geo(geom, hit.slot, hit.u, hit.v)
    tangent = build_onb(n)[0]   # the fiber frame of a triangle

    # hit from behind the geometric normal (shader.c:500)
    inside = torch.sum(wi * gn, dim=-1) > 0.0

    m = scene.materials
    mat = torch.clamp(mat, 0, m.kind.shape[0] - 1)
    rd = m.d_mul[mat, None] * rgb2spec.eval_coeff(m.d_coeff[mat][..., None, :],
                                                  lam)
    rd = torch.clamp(rd, 0.0, 1.0)
    ck = checker_albedo(m.checker_spectra, st, lam)
    rd = torch.where(m.use_checker[mat][..., None],
                     torch.clamp(m.d_mul[mat, None] * ck, 0.0, 1.0), rd)
    rg = torch.clamp(m.g_mul[mat, None] * rgb2spec.eval_coeff(
        m.g_coeff[mat][..., None, :], lam), 0.0, 1.0)
    em = m.e_mul[mat, None] * rgb2spec.eval_coeff(m.e_coeff[mat][..., None, :],
                                                  lam)
    rough = m.roughness[mat]

    # dielectric spectral IOR (Cauchy from Abbe); n1/n2 along propagation
    eta = _eta_from_abbe_batched(m.ior_nd[mat], m.ior_abbe[mat], lam)
    eta_ratio = torch.where(inside[..., None], eta, 1.0 / eta)

    valid = hit.prim >= 0
    rd = torch.where(valid[..., None], rd, 0.0)
    rg = torch.where(valid[..., None], rg, 0.0)
    em = torch.where(valid[..., None], em, 0.0)

    f_n, f_k = fresnel_data.eval_nk(m.fres_n[mat], m.fres_k[mat], lam)
    return ShadingPoint(
        kind=torch.where(valid, m.kind[mat], -1),
        rd=rd, rg=rg, em=em, roughness=rough,
        eta_ratio=eta_ratio, fresnel_eta=f_n, fresnel_k=f_k,
        n=n, gn=gn, inside=inside, tangent=tangent)


def _eta_from_abbe_batched(n_d, v_d, lam):
    """Batched Cauchy IOR (cie.eta_from_abbe with tensor n_d/v_d)."""
    l_c, l_f, l_d = 0.6563, 0.4861, 0.587561
    c = (l_c * l_c * l_f * l_f) / (l_c * l_c - l_f * l_f)
    safe_v = torch.where(v_d == 0.0, 1.0, v_d)
    b = torch.where(v_d == 0.0, 0.0, (n_d - 1.0) / safe_v * c)
    a = n_d - b / (l_d * l_d)
    return a[..., None] + (b[..., None] * 1e6) / (lam * lam)
