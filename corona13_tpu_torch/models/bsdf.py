"""BSDF models with a unified batched sample/eval/pdf interface
(corona13_tpu/models/bsdf.py).

Materials are a small static enum dispatched with masked evaluation over
the wavefront.  ``sample`` returns (wo, pdf, weight) with pdf in projected
solid angle and weight = f/pdf; ``eval_pdf`` returns the BSDF value and
pdf of a connection.  ``wi`` points into the vertex, ``wo`` away from it.
Spectral quantities carry a trailing hero axis [MF].

Kinds: DIFFUSE, DIELECTRIC, METAL, DIFFDIEL, NULL and HAIR (a fibre
model on line prims: Kajiya-Kay diffuse plus a gaussian longitudinal
specular cone around the fibre tangent ``ShadingPoint.tangent``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.math import build_onb, dot, from_frame, normalize

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

ALL_KINDS = (DIFFUSE, DIELECTRIC, METAL, DIFFDIEL, HAIR)


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


def fresnel_conductor(eta, k, cos_i):
    """Conductor fresnel for complex IOR eta - i*k."""
    c = torch.clamp(cos_i, 1e-6, 1.0)
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=1e-12))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=1e-12))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return torch.clamp(0.5 * (rs + rp), 0.0, 1.0)


# --- GGX visible-normal distribution (Heitz 2018) --------------------------

def ggx_smith_g1(cos_wn, roughness):
    r2 = roughness * roughness
    c2 = torch.clamp(cos_wn * cos_wn, 1e-12, 1.0)
    t2 = (1.0 - c2) / c2
    return 2.0 / (1.0 + torch.sqrt(1.0 + r2 * t2))


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
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where(lensq[..., None] > 1e-12,
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     ex.expand(vh.shape))
    t2v = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(r1)
    phi = 2.0 * math.pi * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))
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
    s = torch.sqrt(r1)
    z = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
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
                        torch.sqrt(torch.clamp(cos_t2, min=1e-12)))
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
                          torch.sqrt(torch.clamp(cos_t2_l, min=1e-12)))
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
                          torch.sqrt(torch.clamp(cos_t2_r, min=1e-12)))
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
                          torch.sqrt(torch.clamp(cos_t2_l, min=1e-12)))
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


# --- diffuse-coated dielectric (diffdiel) ----------------------------------

def _diffdiel_fresnel(sp: ShadingPoint, cos_in):
    """Non-reciprocal fresnel on the surface-normal cosine (reference
    diffdiel.c:259-265: n1 = eta_ratio, n2 = 1, R evaluated at cos_in
    rather than the half-vector cosine)."""
    n1, n2 = sp.eta_ratio, torch.ones_like(sp.eta_ratio)
    nr = n1 / n2
    cos_t2 = 1.0 - nr * nr * (1.0 - cos_in[..., None] ** 2)
    cos_t = torch.where(cos_t2 <= 0.0, 0.0,
                        torch.sqrt(torch.clamp(cos_t2, min=1e-12)))
    return fresnel_dielectric(n1, n2, cos_in[..., None], cos_t)


def diffdiel_sample(sp: ShadingPoint, wi, r1, r2, r_mode):
    """Sample reflect (GGX or specular mirror) against diffuse transmit
    (a cosine lobe into the surface with f = rg (1-R) / pi).
    Returns (wo, pdf_proj[MF], weight[MF], is_specular, did_transmit)."""
    n = _flip(sp, sp.n)
    r = sp.roughness
    rr = torch.clamp(r, min=GLOSSY_THR)
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)

    u, v = build_onb(n)
    wi_t = torch.stack([-dot(u, wi), -dot(v, wi), cos_in], dim=-1)
    h_t = ggx_sample_vndf(wi_t, rr, r1, r2)
    h = torch.where(glossy[..., None], from_frame(u, v, n, h_t), n)
    cos_r = -dot(wi, h)
    pdf_h = torch.where(glossy, ggx_pdf_h(dot(h, n), cos_in, cos_r, rr), 1.0)

    big_r = _diffdiel_fresnel(sp, cos_in)
    do_reflect = r_mode <= big_r[..., 0]

    # reflection branch (the dielectric reflect lobe)
    wo_r = wi + 2.0 * cos_r[..., None] * h
    cos_out_r = dot(wo_r, n)
    ok_r = (cos_out_r > 0.0) & (cos_r > 0.0) & (cos_in > 0.0)
    pdf_proj_r = torch.where(
        glossy[..., None],
        big_r * (pdf_h / (4.0 * torch.clamp(cos_r, min=1e-12))
                 / torch.clamp(torch.abs(cos_out_r), min=1e-12))[..., None],
        big_r)
    g1_r = ggx_smith_g1(cos_out_r, rr)
    w_r = torch.where(glossy[..., None], sp.rg * g1_r[..., None], sp.rg)
    w_r = torch.where(ok_r[..., None], w_r, 0.0)

    # diffuse transmission branch: cosine lobe around -n
    phi = 2.0 * math.pi * r2
    s = torch.sqrt(r1)
    z = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    wo_t = (-z[..., None] * n + (s * torch.cos(phi))[..., None] * u
            + (s * torch.sin(phi))[..., None] * v)
    pdf_proj_t = (1.0 - big_r) / math.pi
    ok_t = cos_in > 0.0
    w_t = torch.where(ok_t[..., None], sp.rg, 0.0)

    wo = torch.where(do_reflect[..., None], wo_r, wo_t)
    pdf = torch.where(do_reflect[..., None], pdf_proj_r, pdf_proj_t)
    w = torch.where(do_reflect[..., None], w_r, w_t)
    return wo, pdf, w, ~glossy & do_reflect, ~do_reflect


def diffdiel_eval_pdf(sp: ShadingPoint, wi, wo):
    """Eval + pdf for connections: the diffuse transmit lobe always
    connects, the reflect lobe only when glossy."""
    n = _flip(sp, sp.n)
    r = sp.roughness
    rr = torch.clamp(r, min=GLOSSY_THR)
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)
    cos_out = dot(n, wo)
    big_r = _diffdiel_fresnel(sp, cos_in)

    # reflect lobe (glossy only)
    h = normalize(wi - wo)
    h = torch.where(dot(h, n)[..., None] < 0.0, -h, h)
    cos_h = torch.abs(dot(h, n))
    cos_r = torch.abs(dot(h, wi))
    d = ggx_ndf(cos_h, rr)
    g2 = ggx_smith_g1(cos_in, rr) * ggx_smith_g1(cos_out, rr)
    f_refl = big_r * sp.rg * (d * g2 / torch.clamp(
        4.0 * torch.abs(cos_in) * torch.abs(cos_out), min=1e-12))[..., None]
    pdf_h = ggx_pdf_h(cos_h, cos_in, cos_r, rr)
    pdf_refl = big_r * (pdf_h / torch.clamp(
        4.0 * cos_r * torch.abs(cos_out), min=1e-12))[..., None]
    refl_ok = glossy & (cos_out > 0.0)

    # diffuse transmit lobe
    one_m_r = torch.clamp(1.0 - big_r, 0.0, 1.0)
    f_trans = sp.rg * one_m_r / math.pi
    pdf_trans = one_m_r / math.pi
    trans_ok = cos_out < 0.0

    f = torch.where(refl_ok[..., None], f_refl,
                    torch.where(trans_ok[..., None], f_trans, 0.0))
    pdf = torch.where(refl_ok[..., None], pdf_refl,
                      torch.where(trans_ok[..., None], pdf_trans, 0.0))
    valid = cos_in > 0.0
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid[..., None], pdf, 0.0))


# --- metal (conductor) -----------------------------------------------------

def metal_sample(sp: ShadingPoint, wi, r1, r2):
    """GGX conductor; rough or specular mirror."""
    n = _flip(sp, sp.n)
    r = sp.roughness
    rr = torch.clamp(r, min=GLOSSY_THR)
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)
    u, v = build_onb(n)
    wi_t = torch.stack([-dot(u, wi), -dot(v, wi), cos_in], dim=-1)
    h_t = ggx_sample_vndf(wi_t, rr, r1, r2)
    h = torch.where(glossy[..., None], from_frame(u, v, n, h_t), n)
    cos_r = -dot(wi, h)
    wo = wi + 2.0 * cos_r[..., None] * h
    cos_out = dot(wo, n)
    fr = fresnel_conductor(sp.fresnel_eta, sp.fresnel_k, cos_r[..., None])
    pdf_h = torch.where(glossy, ggx_pdf_h(dot(h, n), cos_in, cos_r, rr), 1.0)
    pdf = torch.where(glossy[..., None],
                      (pdf_h / (4.0 * torch.clamp(cos_r, min=1e-12))
                       / torch.clamp(torch.abs(cos_out), min=1e-12))[..., None],
                      torch.ones_like(fr))
    g1o = ggx_smith_g1(cos_out, rr)
    w = fr * sp.rg * torch.where(glossy, g1o, 1.0)[..., None]
    ok = (cos_out > 0.0) & (cos_r > 0.0) & (cos_in > 0.0)
    w = torch.where(ok[..., None], w, 0.0)
    return wo, pdf, w, ~glossy


def metal_eval_pdf(sp: ShadingPoint, wi, wo):
    n = _flip(sp, sp.n)
    r = sp.roughness
    rr = torch.clamp(r, min=GLOSSY_THR)
    glossy = r > GLOSSY_THR
    cos_in = -dot(n, wi)
    cos_out = dot(n, wo)
    h = normalize(wi - wo)
    h = torch.where(dot(h, n)[..., None] < 0.0, -h, h)
    cos_h = torch.abs(dot(h, n))
    cos_r = torch.abs(dot(h, wi))
    fr = fresnel_conductor(sp.fresnel_eta, sp.fresnel_k, cos_r[..., None])
    d = ggx_ndf(cos_h, rr)
    g2 = ggx_smith_g1(cos_in, rr) * ggx_smith_g1(cos_out, rr)
    f = fr * sp.rg * (d * g2 / torch.clamp(
        4.0 * torch.abs(cos_in) * torch.abs(cos_out), min=1e-12))[..., None]
    pdf_h = ggx_pdf_h(cos_h, cos_in, cos_r, rr)
    pdf = (pdf_h / torch.clamp(4.0 * cos_r * torch.abs(cos_out),
                               min=1e-12))[..., None]
    pdf = pdf.expand(f.shape)
    valid = glossy & (cos_in > 0.0) & (cos_out > 0.0)
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid[..., None], pdf, 0.0))


# --- hair fibre ------------------------------------------------------------

_HAIR_BETA_MIN = 0.02


def _hair_frame(sp, wi):
    """Fibre frame: tangent T, an ONB (U, V) around it, and the incoming
    tangential component ci = dot(T, -wi) that the specular cone keeps
    (reflection off a cylinder flips only the radial part)."""
    t = normalize(sp.tangent if sp.tangent is not None else sp.n)
    u, v = build_onb(t)
    return t, u, v, dot(t, -wi)


def _hair_lobes(sp):
    """Per-lane lobe energies (hero lane 0): diffuse rd, specular rg."""
    e_d = torch.clamp(sp.rd[..., 0], min=0.0)
    e_s = torch.clamp(sp.rg[..., 0], min=0.0)
    tot = torch.clamp(e_d + e_s, min=1e-12)
    return e_d / tot, e_s / tot


def _hair_spec_norm(ci, beta):
    """Truncated-gaussian normalisation over co in [-1, 1]."""
    s = beta * math.sqrt(2.0)
    return torch.clamp(0.5 * (torch.erf((1.0 - ci) / s)
                              - torch.erf((-1.0 - ci) / s)), min=1e-6)


def _hair_gauss(co, ci, beta):
    return torch.exp(-0.5 * ((co - ci) / beta) ** 2) / \
        (beta * math.sqrt(2.0 * math.pi))


def hair_S(sp, wi, wo):
    """Fibre scattering distribution S(wo) per solid angle [N, MF]
    (energy-normalised): Kajiya-Kay diffuse sin(theta)/pi^2 + gaussian
    longitudinal specular cone / (2 pi norm)."""
    t, _, _, ci = _hair_frame(sp, wi)
    co = dot(t, wo)
    sin_o = torch.sqrt(torch.clamp(1.0 - co * co, min=1e-12))
    beta = torch.clamp(sp.roughness, min=_HAIR_BETA_MIN)
    s_d = sp.rd * (sin_o / (math.pi ** 2))[..., None]
    g = _hair_gauss(co, ci, beta)
    s_s = sp.rg * (g / (_hair_spec_norm(ci, beta) * 2.0 * math.pi))[..., None]
    return s_d + s_s


def hair_pdf_w(sp, wi, wo):
    """Solid-angle pdf of hair_sample's lobe mixture."""
    t, _, _, ci = _hair_frame(sp, wi)
    co = dot(t, wo)
    beta = torch.clamp(sp.roughness, min=_HAIR_BETA_MIN)
    p_d, p_s = _hair_lobes(sp)
    pdf_diff = 1.0 / (4.0 * math.pi)
    pdf_spec = _hair_gauss(co, ci, beta) / \
        (_hair_spec_norm(ci, beta) * 2.0 * math.pi)
    return p_d * pdf_diff + p_s * pdf_spec


def hair_eval_pdf(sp, wi, wo):
    """(f, pdf_proj) in the surface convention: the pipeline multiplies
    |cos(n, wo)| into NEE and extension, so f = S/|cos| and
    pdf_proj = pdf_w/|cos| keep the fibre distribution intact."""
    cos_n = torch.clamp(torch.abs(dot(sp.n, wo)), min=1e-4)
    f = hair_S(sp, wi, wo) / cos_n[..., None]
    pdf_proj = hair_pdf_w(sp, wi, wo) / cos_n
    return f, pdf_proj[..., None].expand(f.shape)


def hair_sample(sp, wi, r1, r2, r_mode):
    """Sample the lobe mixture; returns (wo, pdf_proj[MF], w[MF]) with
    w = S/pdf_w (the f |cos| / pdf convention of the other kinds)."""
    t, u, v, ci = _hair_frame(sp, wi)
    beta = torch.clamp(sp.roughness, min=_HAIR_BETA_MIN)
    _, p_s = _hair_lobes(sp)
    phi = 2.0 * math.pi * r2
    co_d = 2.0 * r1 - 1.0                       # diffuse: uniform sphere
    # specular: truncated gaussian around ci by its inverse CDF
    s = beta * math.sqrt(2.0)
    lo = torch.erf((-1.0 - ci) / s)
    hi = torch.erf((1.0 - ci) / s)
    co_s = ci + s * torch.erfinv(torch.clamp(lo + r1 * (hi - lo),
                                             -1 + 1e-7, 1 - 1e-7))
    use_s = r_mode < p_s
    co = torch.clamp(torch.where(use_s, co_s, co_d), -1.0 + 1e-6, 1.0 - 1e-6)
    sin_o = torch.sqrt(1.0 - co * co)
    wo = normalize(co[..., None] * t
                   + (sin_o * torch.cos(phi))[..., None] * u
                   + (sin_o * torch.sin(phi))[..., None] * v)
    pdf_w = hair_pdf_w(sp, wi, wo)
    w = hair_S(sp, wi, wo) / torch.clamp(pdf_w, min=1e-12)[..., None]
    cos_n = torch.clamp(torch.abs(dot(sp.n, wo)), min=1e-4)
    pdf_proj = (pdf_w / cos_n)[..., None].expand(w.shape)
    return wo, pdf_proj, w


# --- dispatch --------------------------------------------------------------

def bsdf_sample(sp: ShadingPoint, wi, r1, r2, r_mode, kinds=ALL_KINDS):
    """Sample the lobes of the kinds the scene uses and select per lane.

    Returns (wo, pdf_proj[MF], weight[MF], mode_bits[int64])."""
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
    if METAL in kinds:
        wo_m, pdf_m, w_m, spec_m = metal_sample(sp, wi, r1, r2)
        is_m = sp.kind == METAL
        wo = torch.where(is_m[..., None], wo_m, wo)
        pdf = torch.where(is_m[..., None], pdf_m, pdf)
        w = torch.where(is_m[..., None], w_m, w)
        m_mode = torch.where(spec_m, MODE_SPECULAR, MODE_GLOSSY) | MODE_REFLECT
        mode = torch.where(is_m, m_mode, mode)
    if DIFFDIEL in kinds:
        wo_s, pdf_s, w_s, spec_s, trans_s = diffdiel_sample(sp, wi, r1, r2,
                                                            r_mode)
        is_s = sp.kind == DIFFDIEL
        wo = torch.where(is_s[..., None], wo_s, wo)
        pdf = torch.where(is_s[..., None], pdf_s, pdf)
        w = torch.where(is_s[..., None], w_s, w)
        s_mode = (torch.where(spec_s, MODE_SPECULAR,
                              torch.where(trans_s, MODE_DIFFUSE, MODE_GLOSSY))
                  | torch.where(trans_s, MODE_TRANSMIT, MODE_REFLECT))
        mode = torch.where(is_s, s_mode, mode)
    if HAIR in kinds:
        wo_f, pdf_f, w_f = hair_sample(sp, wi, r1, r2, r_mode)
        is_f = sp.kind == HAIR
        wo = torch.where(is_f[..., None], wo_f, wo)
        pdf = torch.where(is_f[..., None], pdf_f, pdf)
        w = torch.where(is_f[..., None], w_f, w)
        mode = torch.where(is_f, MODE_GLOSSY | MODE_REFLECT, mode)
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
    if METAL in kinds:
        is_m = (sp.kind == METAL)[..., None]
        f_m, p_m = metal_eval_pdf(sp, wi, wo)
        f = torch.where(is_m, f_m, f)
        pdf = torch.where(is_m, p_m, pdf)
    if DIFFDIEL in kinds:
        is_s = (sp.kind == DIFFDIEL)[..., None]
        f_s, p_s = diffdiel_eval_pdf(sp, wi, wo)
        f = torch.where(is_s, f_s, f)
        pdf = torch.where(is_s, p_s, pdf)
    if HAIR in kinds:
        is_f = (sp.kind == HAIR)[..., None]
        f_f, p_f = hair_eval_pdf(sp, wi, wo)
        f = torch.where(is_f, f_f, f)
        pdf = torch.where(is_f, p_f, pdf)
    return f, pdf
