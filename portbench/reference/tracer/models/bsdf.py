# Frozen copy of corona13_tpu_torch/models/bsdf.py (lines 1-691) as of commit 2084081, for the benchmark's plain reference.
"""BSDF models with a unified batched sample/eval/pdf interface
(corona13_tpu/models/bsdf.py).

Materials are a small static enum dispatched with masked evaluation over
the wavefront.  ``sample`` returns (wo, pdf, weight) with pdf in projected
solid angle and weight = f/pdf; ``eval_pdf`` returns the BSDF value and
pdf of a connection.  ``wi`` points into the vertex, ``wo`` away from it.
Spectral quantities carry a trailing hero axis [MF].

Kinds: DIFFUSE, DIELECTRIC and NULL, the kinds of the benchmark's
scenes; METAL, DIFFDIEL and HAIR are named, for the scene loader, and
refused.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.math import build_onb, dot, from_frame, normalize, rsqrt, sqrt

# BSDF kinds (host shaders)
DIFFUSE = 0
DIELECTRIC = 1
METAL = 2
NULL = 3
DIFFDIEL = 4
HAIR = 5

# vertex mode bits (subset of reference pathspace.h:57-72)
MODE_ABSORB = 0
MODE_DIFFUSE = 1 << 0
MODE_GLOSSY = 1 << 1
MODE_SPECULAR = 1 << 2
MODE_REFLECT = 1 << 3
MODE_TRANSMIT = 1 << 4
MODE_EMIT = 1 << 5
MODE_VOLUME = 1 << 6

GLOSSY_THR = 1e-3  # roughness below which we go specular (dielectric.c:35)

ALL_KINDS = (DIFFUSE, DIELECTRIC)


@dataclasses.dataclass
class ShadingPoint:
    """Per-vertex shading state after shader_prepare."""
    kind: torch.Tensor       # [N] int64 BSDF enum
    rd: torch.Tensor         # [N, MF] diffuse reflectance
    rg: torch.Tensor         # [N, MF] glossy coefficient
    em: torch.Tensor         # [N, MF] emission
    roughness: torch.Tensor  # [N]
    eta_ratio: torch.Tensor  # [N, MF] n1/n2 along propagation (dielectric)
    fresnel_eta: torch.Tensor  # [N, MF] conductor n (metal)
    fresnel_k: torch.Tensor    # [N, MF] conductor k (metal)
    n: torch.Tensor          # [N, 3] shading normal
    gn: torch.Tensor         # [N, 3] geometric normal
    inside: torch.Tensor     # [N] bool: hit from the inside
    tangent: torch.Tensor | None = None  # [N, 3] fiber direction


def _flip(sp: ShadingPoint, x):
    return torch.where(sp.inside[..., None], -x, x)


def fresnel_dielectric(n1, n2, cos_r, cos_t):
    """Unpolarized dielectric fresnel; 1 for TIR (cos_t <= 0), with the
    JAX package's division guards."""
    ds = n1 * cos_r + n2 * cos_t
    dp = n2 * cos_r + n1 * cos_t
    ds = torch.where(torch.abs(ds) > 1e-12, ds, 1e-12)
    dp = torch.where(torch.abs(dp) > 1e-12, dp, 1e-12)
    rs = (n1 * cos_r - n2 * cos_t) / ds
    rp = (n2 * cos_r - n1 * cos_t) / dp
    r = torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0)
    return torch.where(cos_t <= 0.0, 1.0, r)


def ggx_smith_g1(cos_wn, roughness):
    r2 = roughness * roughness
    c2 = torch.clamp(cos_wn * cos_wn, 1e-12, 1.0)
    t2 = (1.0 - c2) / c2
    return 2.0 / (1.0 + sqrt(1.0 + r2 * t2))


def ggx_ndf(cos_h, roughness):
    r2 = roughness * roughness
    c2 = torch.clamp(cos_h * cos_h, 1e-12, 1.0)
    t2 = (1.0 - c2) / c2
    den = c2 * c2 * (r2 + t2) ** 2
    return r2 / torch.clamp(math.pi * den, min=1e-20)


def ggx_sample_vndf(wi_t, roughness, r1, r2):
    """Sample a visible microfacet normal in tangent space.
    wi_t: [...,3] direction away from the surface (z up), z > 0."""
    a = roughness
    vh = normalize(torch.stack([a * wi_t[..., 0], a * wi_t[..., 1],
                                wi_t[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = rsqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where(lensq[..., None] > 1e-12,
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     ex.expand(vh.shape))
    t2v = torch.linalg.cross(vh, t1, dim=-1)
    r = sqrt(r1)
    phi = 2.0 * math.pi * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)) + s * p2
    p3 = sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))
    nh = p1[..., None] * t1 + p2[..., None] * t2v + p3[..., None] * vh
    return normalize(torch.stack([a * nh[..., 0], a * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=0.0)], dim=-1))


def ggx_pdf_h(cos_h, cos_in, cos_r, roughness):
    """VNDF pdf of half vector h given wi: G1(wi) |wi.h| D(h) / |wi.n|."""
    d = ggx_ndf(cos_h, roughness)
    g1 = ggx_smith_g1(cos_in, roughness)
    return torch.abs(g1 * cos_r * d /
                     torch.where(torch.abs(cos_in) < 1e-8, 1e-8, cos_in))


# --- diffuse ---------------------------------------------------------------

def diffuse_sample(sp: ShadingPoint, wi, r1, r2):
    """Cosine sampling off the shading normal; directions below the
    geometric horizon get weight 0."""
    n = _flip(sp, sp.n)
    gn = _flip(sp, sp.gn)
    u, v = build_onb(n)
    phi = 2.0 * math.pi * r2
    s = sqrt(r1)
    z = sqrt(torch.clamp(1.0 - r1, min=0.0))
    wo = (z[..., None] * n + (s * torch.cos(phi))[..., None] * u
          + (s * torch.sin(phi))[..., None] * v)
    pdf = torch.full_like(sp.rd, 1.0 / math.pi)
    ok = dot(gn, wo) > 0.0
    w = torch.where(ok[..., None], sp.rd, 0.0)
    return wo, pdf, w


def diffuse_eval(sp: ShadingPoint, wi, wo):
    n = _flip(sp, sp.n)
    gn = _flip(sp, sp.gn)
    ok = (dot(n, wo) > 0.0) & (dot(gn, wo) > 0.0) & (dot(n, -wi) > 0.0)
    return torch.where(ok[..., None], sp.rd / math.pi, 0.0)


def diffuse_pdf(sp: ShadingPoint, wi, wo):
    n = _flip(sp, sp.n)
    ok = (dot(n, wo) > 0.0) & (dot(n, -wi) > 0.0)
    return torch.where(ok[..., None], torch.full_like(sp.rd, 1.0 / math.pi),
                       0.0)


# --- rough/smooth dielectric ----------------------------------------------

def dielectric_sample(sp: ShadingPoint, wi, r1, r2, r_mode):
    """GGX dielectric sampling; specular transmission keeps the hero lane
    only.  Returns (wo, pdf_proj[MF], weight[MF], is_specular,
    did_transmit)."""
    mf = sp.eta_ratio.shape[-1]
    n1, n2 = sp.eta_ratio, torch.ones_like(sp.eta_ratio)
    n = _flip(sp, sp.n)
    r = sp.roughness
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)

    u, v = build_onb(n)
    wi_t = torch.stack([-dot(u, wi), -dot(v, wi), cos_in], dim=-1)
    rr = torch.clamp(r, min=GLOSSY_THR)
    h_t = ggx_sample_vndf(wi_t, rr, r1, r2)
    h = torch.where(glossy[..., None], from_frame(u, v, n, h_t), n)
    cos_r = -dot(wi, h)
    pdf_h = torch.where(glossy, ggx_pdf_h(dot(h, n), cos_in, cos_r, rr), 1.0)

    nr = n1 / n2
    cos_t2 = 1.0 - nr * nr * (1.0 - cos_r[..., None] ** 2)
    cos_t = torch.where(cos_t2 <= 0.0, 0.0,
                        sqrt(torch.clamp(cos_t2, min=1e-12)))
    big_r = fresnel_dielectric(n1, n2, cos_r[..., None], cos_t)
    do_reflect = r_mode <= big_r[..., 0]

    # reflection branch
    wo_r = wi + 2.0 * cos_r[..., None] * h
    pdf_r = pdf_h / (4.0 * torch.clamp(cos_r, min=1e-12))
    cos_out_r = dot(wo_r, n)
    g1_r = ggx_smith_g1(cos_out_r, rr)
    ok_r = (cos_out_r > 0.0) & (cos_r > 0.0)
    pdf_proj_r = torch.where(
        glossy[..., None],
        big_r * (pdf_r / torch.clamp(torch.abs(cos_out_r), min=1e-12))[..., None],
        big_r)
    w_r = torch.where(glossy[..., None], sp.rg * g1_r[..., None], sp.rg)
    w_r = torch.where(ok_r[..., None], w_r, 0.0)

    # transmission branch (hero lane direction)
    eta0 = sp.eta_ratio[..., 0]
    f = eta0 * cos_r - cos_t[..., 0]
    wo_t = normalize(wi * eta0[..., None] + f[..., None] * h)
    cos_out_t = dot(wo_t, n)
    ok_t = (cos_out_t < 0.0) & (cos_r > 0.0) & (cos_t2[..., 0] > 0.0)

    # per-lane half-vector reconstruction for glossy transmit
    h_l = n1[..., None] * wi[..., None, :] - n2[..., None] * wo_t[..., None, :]
    h_l = normalize(h_l) * torch.sign(n2 - n1)[..., None]
    cos_h_l = torch.sum(h_l * n[..., None, :], dim=-1)
    cos_r_l = torch.sum(h_l * (-wi[..., None, :]), dim=-1)
    lane_ok = (cos_h_l > 0.0) & (cos_r_l > 0.0)
    cos_t2_l = 1.0 - nr * nr * (1.0 - cos_r_l * cos_r_l)
    cos_t_l = torch.where(cos_t2_l <= 0.0, 0.0,
                          sqrt(torch.clamp(cos_t2_l, min=1e-12)))
    r_l = fresnel_dielectric(n1, n2, cos_r_l, cos_t_l)
    denom = n1 * cos_r_l - n2 * cos_t_l
    jac_t = n2 * n2 * cos_t_l / torch.clamp(denom * denom, min=1e-20)
    pdf_h_l = ggx_pdf_h(cos_h_l, cos_in[..., None], cos_r_l, rr[..., None])
    pdf_proj_t_glossy = torch.where(
        lane_ok, pdf_h_l * jac_t * (1.0 - r_l)
        / torch.clamp(torch.abs(cos_out_t)[..., None], min=1e-12), 0.0)
    g1_t = ggx_smith_g1(cos_out_t, rr)

    hero_mask = torch.arange(mf, device=n.device) == 0
    pdf_proj_t = torch.where(glossy[..., None], pdf_proj_t_glossy,
                             torch.where(hero_mask, 1.0 - big_r, 0.0))
    w_t_glossy = torch.where(lane_ok, sp.rg * g1_t[..., None], 0.0)
    w_t_spec = torch.where(hero_mask, sp.rg, 0.0)
    w_t = torch.where(glossy[..., None], w_t_glossy, w_t_spec)
    w_t = torch.where(ok_t[..., None], w_t, 0.0)

    wo = torch.where(do_reflect[..., None], wo_r, wo_t)
    pdf = torch.where(do_reflect[..., None], pdf_proj_r, pdf_proj_t)
    w = torch.where(do_reflect[..., None], w_r, w_t)
    # F/detach(F) (resp. (1-F)/detach(1-F)): primal as in the JAX package,
    # while the backward pass keeps d f / d ior at specular lanes
    f_att = torch.where(
        do_reflect[..., None],
        big_r / torch.clamp(big_r.detach(), min=1e-6),
        (1.0 - big_r) / torch.clamp((1.0 - big_r).detach(), min=1e-6))
    w = w * torch.where(glossy[..., None], 1.0, f_att)
    return wo, pdf, w, ~glossy, ~do_reflect


def dielectric_eval_pdf(sp: ShadingPoint, wi, wo):
    """Joint eval + pdf of the glossy lobes (specular lobes give 0).
    Returns (f[MF], pdf_proj[MF])."""
    n1, n2 = sp.eta_ratio, torch.ones_like(sp.eta_ratio)
    n = _flip(sp, sp.n)
    r = sp.roughness
    rr = torch.clamp(r, min=GLOSSY_THR)
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)
    cos_out = dot(n, wo)
    reflectb = cos_out > 0.0
    nr = n1 / n2

    h_r = normalize(wi - wo)
    h_r = torch.where(dot(h_r, n)[..., None] < 0.0, -h_r, h_r)
    cos_h_r = torch.abs(dot(h_r, n))
    cos_r_r = torch.abs(dot(h_r, wi))
    cos_t2_r = 1.0 - nr * nr * (1.0 - cos_r_r[..., None] ** 2)
    cos_t_r = torch.where(cos_t2_r <= 0.0, 0.0,
                          sqrt(torch.clamp(cos_t2_r, min=1e-12)))
    big_r_r = fresnel_dielectric(n1, n2, cos_r_r[..., None], cos_t_r)
    d_r = ggx_ndf(cos_h_r, rr)
    g2_r = ggx_smith_g1(cos_in, rr) * ggx_smith_g1(cos_out, rr)
    f_refl = big_r_r * (d_r * g2_r / torch.clamp(
        4.0 * torch.abs(cos_in) * torch.abs(cos_out), min=1e-12))[..., None] * sp.rg
    pdf_h_r = ggx_pdf_h(cos_h_r, cos_in, cos_r_r, rr)
    pdf_refl = big_r_r * (pdf_h_r / torch.clamp(
        4.0 * cos_r_r * torch.abs(cos_out), min=1e-12))[..., None]

    h_l = n1[..., None] * wi[..., None, :] - n2[..., None] * wo[..., None, :]
    h_l = normalize(h_l) * torch.sign(n2 - n1)[..., None]
    cos_h_l = torch.sum(h_l * n[..., None, :], dim=-1)
    cos_r_l = torch.sum(h_l * (-wi[..., None, :]), dim=-1)
    lane_ok = (cos_h_l > 0.0) & (cos_r_l > 0.0)
    cos_t2_l = 1.0 - nr * nr * (1.0 - cos_r_l * cos_r_l)
    cos_t_l = torch.where(cos_t2_l <= 0.0, 0.0,
                          sqrt(torch.clamp(cos_t2_l, min=1e-12)))
    big_r_l = fresnel_dielectric(n1, n2, cos_r_l, cos_t_l)
    denom = n1 * cos_r_l - n2 * cos_t_l
    jac = n2 * n2 * cos_t_l / torch.clamp(denom * denom, min=1e-20)
    d_l = ggx_ndf(cos_h_l, rr[..., None])
    g2_l = (ggx_smith_g1(cos_in, rr) * ggx_smith_g1(cos_out, rr))[..., None]
    f_trans = (1.0 - big_r_l) * d_l * g2_l * cos_r_l * jac \
        / torch.clamp(torch.abs(cos_in) * torch.abs(cos_out),
                      min=1e-12)[..., None] * sp.rg
    f_trans = torch.where(lane_ok, f_trans, 0.0)
    pdf_h_l = ggx_pdf_h(cos_h_l, cos_in[..., None], cos_r_l, rr[..., None])
    pdf_trans = torch.where(lane_ok, pdf_h_l * jac * (1.0 - big_r_l)
                            / torch.clamp(torch.abs(cos_out),
                                          min=1e-12)[..., None], 0.0)

    f = torch.where(reflectb[..., None], f_refl, f_trans)
    pdf = torch.where(reflectb[..., None], pdf_refl, pdf_trans)
    valid = glossy & (cos_in > 0.0)
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid[..., None], pdf, 0.0))


# --- dispatch --------------------------------------------------------------

def _covered(kinds):
    """Refuse the kinds whose lobes the reference does not carry."""
    left = set(kinds) & {METAL, DIFFDIEL, HAIR}
    if left:
        raise ValueError(f'the plain reference covers the benchmark\'s BSDF '
                         f'kinds; this scene has kinds {sorted(left)}')


def bsdf_sample(sp: ShadingPoint, wi, r1, r2, r_mode, kinds=ALL_KINDS):
    """Sample the lobes of the kinds the scene uses and select per lane.

    Returns (wo, pdf_proj[MF], weight[MF], mode_bits[int64])."""
    _covered(kinds)
    wo = wi
    pdf = torch.zeros_like(sp.rd)
    w = torch.zeros_like(sp.rd)
    mode = torch.zeros(wi.shape[:-1], dtype=torch.int64, device=wi.device)

    if DIFFUSE in kinds:
        wo_d, pdf_d, w_d = diffuse_sample(sp, wi, r1, r2)
        is_d = sp.kind == DIFFUSE
        wo = torch.where(is_d[..., None], wo_d, wo)
        pdf = torch.where(is_d[..., None], pdf_d, pdf)
        w = torch.where(is_d[..., None], w_d, w)
        mode = torch.where(is_d, MODE_DIFFUSE | MODE_REFLECT, mode)
    if DIELECTRIC in kinds:
        wo_g, pdf_g, w_g, spec_g, trans_g = dielectric_sample(sp, wi, r1, r2,
                                                              r_mode)
        is_g = sp.kind == DIELECTRIC
        wo = torch.where(is_g[..., None], wo_g, wo)
        pdf = torch.where(is_g[..., None], pdf_g, pdf)
        w = torch.where(is_g[..., None], w_g, w)
        g_mode = (torch.where(spec_g, MODE_SPECULAR, MODE_GLOSSY)
                  | torch.where(trans_g, MODE_TRANSMIT, MODE_REFLECT))
        mode = torch.where(is_g, g_mode, mode)
    if NULL in kinds:
        is_n = sp.kind == NULL
        wo = torch.where(is_n[..., None], wi, wo)
        pdf = torch.where(is_n[..., None], 1.0, pdf)
        w = torch.where(is_n[..., None], 1.0, w)
        mode = torch.where(is_n, MODE_SPECULAR | MODE_TRANSMIT, mode)

    mode = torch.where(torch.any(w > 0.0, dim=-1), mode, MODE_ABSORB)

    # detached-estimator weights for connectable lanes: w = f / detach(p)
    # through the eval path (same primal; see the JAX package), evaluated
    # on a copy whose discarded (specular/absorbed) lanes get roughness 0.5
    discarded = ((mode & MODE_SPECULAR) != 0) | (mode == 0)
    sp_safe = dataclasses.replace(
        sp, roughness=torch.where(discarded, 0.5, sp.roughness))
    f_at, p_at = bsdf_eval_pdf(sp_safe, wi, wo, kinds=kinds)
    p_det = p_at.detach()
    w_att = torch.where(p_det > 0.0,
                        f_at / torch.where(p_det > 0.0, p_det, 1.0), 0.0)
    use_att = (((mode & MODE_SPECULAR) == 0) & (mode != 0))[..., None] \
        & (p_det > 0.0) & torch.isfinite(w_att)
    w = torch.where(use_att, w_att, w)
    return wo, pdf, w, mode


def bsdf_eval_pdf(sp: ShadingPoint, wi, wo, kinds=ALL_KINDS):
    """f and pdf of a connection direction (NEE / MIS); specular lobes
    return 0."""
    _covered(kinds)
    f = torch.zeros_like(sp.rd)
    pdf = torch.zeros_like(sp.rd)
    if DIFFUSE in kinds:
        is_d = (sp.kind == DIFFUSE)[..., None]
        f = torch.where(is_d, diffuse_eval(sp, wi, wo), f)
        pdf = torch.where(is_d, diffuse_pdf(sp, wi, wo), pdf)
    if DIELECTRIC in kinds:
        is_g = (sp.kind == DIELECTRIC)[..., None]
        f_g, p_g = dielectric_eval_pdf(sp, wi, wo)
        f = torch.where(is_g, f_g, f)
        pdf = torch.where(is_g, p_g, pdf)
    return f, pdf
