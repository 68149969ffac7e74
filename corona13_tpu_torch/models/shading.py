"""Hit-point shading preparation (corona13_tpu/models/shading.py).

Given a Hit wavefront: gather the primitive data, compute geometric and
shading normals and texture coordinates, fetch the material row and
evaluate all spectral slots at the path wavelengths.  Triangles, spheres
and lines (truncated cones, whose axis becomes the HAIR fibre tangent) are
shaded; materials with an image texture fetch the nearest texel of the
scene's spectral-coefficient atlas.  Moving prims are shaded from their
shutter-open data, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..spectral import fresnel_data, rgb2spec
from ..utils.math import build_onb, cross, normalize, sqrt
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


def _sphere_geo(geom, local, x):
    c = geom.sph_c[local]
    r = torch.clamp(geom.sph_r[local], min=1e-20)
    n = (x - c) / r[..., None]
    su = torch.atan2(n[..., 1], n[..., 0]) / (2.0 * torch.pi)
    sv = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0)) / torch.pi
    return n, n, torch.stack([su, sv], dim=-1)


def _line_geo(geom, local, x, y_frac):
    """Normal (tilted to the cone surface), st = (axial fraction, 0) and
    the unit axis of line hits."""
    v0 = geom.line_v0[local]
    v1 = geom.line_v1[local]
    r0 = geom.line_r0[local]
    r1 = geom.line_r1[local]
    axis = v1 - v0
    length = sqrt(torch.clamp(torch.sum(axis * axis, dim=-1), min=1e-20))
    d = axis / length[..., None]
    o = x - v0
    ya = torch.sum(o * d, dim=-1)
    radial = normalize(o - ya[..., None] * d)
    n = normalize(radial - d * ((r1 - r0) / length)[..., None])
    return n, n, torch.stack([y_frac, torch.zeros_like(y_frac)], dim=-1), d


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
    prim = torch.clamp(hit.prim, min=0)
    n_t = geom.n_tris
    n_s = geom.n_spheres
    is_sph = (prim >= n_t) & (prim < n_t + n_s)
    is_line = prim >= n_t + n_s

    gn, n, st, mat = _tri_geo(geom, hit.slot, hit.u, hit.v)
    if n_s:
        local = torch.where(is_sph, prim - n_t, 0)
        gn_s, n_s_, st_s = _sphere_geo(geom, local, x)
        gn = torch.where(is_sph[..., None], gn_s, gn)
        n = torch.where(is_sph[..., None], n_s_, n)
        st = torch.where(is_sph[..., None], st_s, st)
        mat = torch.where(is_sph, geom.sph_shader[local], mat)
    tangent = build_onb(n)[0]   # fiber frame fallback for non-line prims
    if geom.n_lines:
        local = torch.where(is_line, prim - n_t - n_s, 0)
        gn_l, n_l, st_l, tan_l = _line_geo(geom, local, x, hit.u)
        gn = torch.where(is_line[..., None], gn_l, gn)
        n = torch.where(is_line[..., None], n_l, n)
        st = torch.where(is_line[..., None], st_l, st)
        tangent = torch.where(is_line[..., None], tan_l, tangent)
        mat = torch.where(is_line, geom.line_shader[local], mat)

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

    if scene.has_textures:
        # nearest texel of the spectral-coefficient atlas at the st coords,
        # evaluated at the path wavelengths
        ti = m.tex_idx[mat]
        has_t = ti >= 0
        tis = torch.clamp(ti, min=0)
        dims = scene.tex_dims[tis]                    # [N, 2] (h, w)
        texel_of = lambda s, size: torch.minimum(
            torch.clamp(torch.remainder(s, 1.0) * size, min=0.0),
            (size - 1).to(s.dtype)).to(torch.int64)
        tx = texel_of(st[..., 0], dims[..., 1])
        ty = texel_of(st[..., 1], dims[..., 0])
        texel = scene.tex_atlas[tis, ty, tx]          # [N, 4] coeffs + mul
        val = (m.tex_mul[mat] * texel[..., 3])[..., None] * \
            rgb2spec.eval_coeff(texel[..., None, :3], lam)
        slot = m.tex_slot[mat]
        rd = torch.where((has_t & (slot == 0))[..., None],
                         torch.clamp(val, 0.0, 1.0), rd)
        rg = torch.where((has_t & (slot == 1))[..., None],
                         torch.clamp(val, 0.0, 1.0), rg)
        em = torch.where((has_t & (slot == 2))[..., None], val, em)

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
