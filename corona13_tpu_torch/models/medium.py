"""Homogeneous participating media (corona13_tpu/models/medium.py).

Absorption, scattering and the HG phase function of the reference's
homogeneous medium shaders (corona-13 src/shaders/medium_rgb.c and the
analytic transmittance / exponential free path of src/shader.c:48-106).
Media parameters live in the material table (``med_*`` columns); a path
tracks its current interior material on a priority stack, and free flight
is sampled against the hero wavelength's extinction with per-lane
spectral reweighting:

    pdf(dist)   = sigma_t_hero * exp(-sigma_t_hero * dist)
    weight_l    = sigma_s_l * exp(-sigma_t_l * dist) / pdf       (scatter)
    pdf(surf)   = exp(-sigma_t_hero * t_hit)
    weight_l    = exp(-sigma_t_l * t_hit) / pdf(surf)            (pass-through)

Every ``stop_gradient`` of the JAX package is a ``.detach()`` at the same
place.
"""

from __future__ import annotations

import math

import torch

from ..ops import hete_cuda
from ..spectral import rgb2spec
from ..utils.math import build_onb, dot, normalize, sqrt


def sigma_t(materials, med, lam):
    """Extinction sigma_t(lambda) [N, MF] for medium material ids ``med``
    (-1 = vacuum -> 0).  med_mut stores 1/mfp fitted spectra."""
    m = torch.clamp(med, min=0)
    st = (materials.med_mut_mul[m, None]
          * rgb2spec.eval_coeff(materials.med_mut_coeff[m][..., None, :], lam))
    return torch.where((med >= 0)[..., None], st, 0.0)


def sigma_s(materials, med, lam):
    """Scattering coefficient sigma_s = sigma_t * albedo(lambda)."""
    m = torch.clamp(med, min=0)
    alb = torch.clamp(
        materials.med_mus_mul[m, None]
        * rgb2spec.eval_coeff(materials.med_mus_coeff[m][..., None, :], lam),
        0.0, 1.0)
    return sigma_t(materials, med, lam) * alb


def transmittance(materials, med, lam, dist):
    """exp(-sigma_t * dist) per hero lane; 1 in vacuum."""
    st = sigma_t(materials, med, lam)
    return torch.exp(-st * torch.clamp(dist, max=1e4)[..., None])


def sample_dist(materials, med, lam, t_hit, rnd):
    """Hero-wavelength free-flight sampling.

    Returns (scatter [N] bool, dist [N], weight [N, MF]): weight is the
    spectral f/p factor of either outcome (scatter at ``dist`` or pass
    through to the surface at ``t_hit``)."""
    st = sigma_t(materials, med, lam)            # [N, MF]
    st_h = st[..., 0]
    in_med = (med >= 0) & (st_h > 0.0)
    st_h_safe = torch.where(in_med, st_h, 1.0)
    # the sampled distance is a sampling decision: detached
    dist = (-torch.log(torch.clamp(1.0 - rnd, min=1e-20)) / st_h_safe).detach()
    scatter = in_med & (dist < t_hit)
    d_eff = torch.where(scatter, dist, t_hit.detach())
    d_eff = torch.clamp(d_eff, max=1e4)
    tr = torch.exp(-st * d_eff[..., None])       # per-lane transmittance
    ss = sigma_s(materials, med, lam)
    # pdf denominators are detached values (f / detach(p))
    pdf_scatter = (st_h_safe[..., None] * tr[..., 0:1]).detach()
    w_scatter = ss * tr / torch.clamp(pdf_scatter, min=1e-30)
    w_surface = tr / torch.clamp(tr[..., 0:1].detach(), min=1e-30)
    w = torch.where(scatter[..., None], w_scatter, w_surface)
    w = torch.where(in_med[..., None], w, 1.0)
    return scatter, dist, w


def _needs_graph(vol, tensors):
    """Whether autograd needs the grid march's gradient on the card: an
    input, lo, hi, sigma_t or sigma_s requires it.  The kernel has none in
    the density: a density that requires grad raises there."""
    if not torch.is_grad_enabled():
        return False
    if vol.density.requires_grad:
        raise NotImplementedError(
            'the grid march on the card has no gradient in the density')
    return any(t.requires_grad for t in (*tensors, vol.lo, vol.hi,
                                         vol.sigma_t, vol.sigma_s))


def _lanes(x, tail=()):
    """``x`` as a contiguous [lanes, *tail] tensor (a view where it can),
    out of any graph: the kernel reads its memory."""
    return x.detach().reshape(-1, *tail).contiguous()


class _ValueOf(torch.autograd.Function):
    """``value`` forward, the gradient of ``surrogate`` (same shape)
    backward: the kernel's result with the plain march's gradient."""

    @staticmethod
    def forward(ctx, value, surrogate):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def grid_sample_plain(vol, med, org, w, t_hit, rnd, scat, dist, wgt):
    """The grid's lanes of :func:`sample_dist_scene` by the plain march:
    ``medium_hete.sample_dist`` kept where ``med`` is the grid's."""
    from . import medium_hete
    in_h = med == vol.mat_id
    s2, d2, w2 = medium_hete.sample_dist(vol, org, w, t_hit, rnd)
    return (torch.where(in_h, s2, scat), torch.where(in_h, d2, dist),
            torch.where(in_h[..., None], w2[..., None], wgt))


def grid_transmit_plain(vol, med, org, w, dist, tr):
    """The grid's lanes of :func:`transmittance_scene` by the plain march."""
    from . import medium_hete
    in_h = med == vol.mat_id
    t2 = medium_hete.transmittance(vol, org, w, dist)
    return torch.where(in_h[..., None], t2[..., None], tr)


def grid_sample_graph(vol, med, org, w, t_hit, rnd, homog, march, aux):
    """The grid's lanes of :func:`sample_dist_scene` with a graph: the
    values of ``march`` (the kernel's scatter and distance), the gradients
    of the plain march.  Its optical depths are sigma_t dx times densities
    whose lookups have no gradient, so from ``aux`` [..., 3] (the first
    crossing's step k, the densities' sum before it, the density at it)
    the distance is a + (k + frac) dx, frac = (target - sigma_t dx
    R_before) / (rho_k sigma_t dx), with [a, b] of ``_segment``."""
    from . import medium_hete
    scat, dist, wgt = homog
    s2, d2 = march
    k, r_before, rho_k = aux.unbind(-1)
    a, b = medium_hete._segment(vol, org, w, t_hit)
    dx = (b - a) / medium_hete.N_MARCH
    target = -torch.log(torch.clamp(1.0 - rnd, min=1e-20))
    frac = (target - vol.sigma_t * dx * r_before) / torch.clamp(
        rho_k * vol.sigma_t * dx, min=1e-20)
    d = torch.where(s2, a + (k + torch.clamp(frac, 0.0, 1.0)) * dx, t_hit)
    w2 = torch.where(s2, medium_hete.scatter_ratio(vol), 1.0)
    in_h = med == vol.mat_id
    return (torch.where(in_h, s2, scat),
            torch.where(in_h, _ValueOf.apply(d2, d), dist),
            torch.where(in_h[..., None], w2[..., None], wgt))


def grid_transmit_graph(vol, med, org, w, dist, tr, march, aux):
    """The grid's lanes of :func:`transmittance_scene` with a graph: the
    kernel's T (``march`` [..., MF]) with the gradient of
    exp(-sigma_t dx R), R = ``aux[..., 0]`` the densities' sum."""
    from . import medium_hete
    a, b = medium_hete._segment(vol, org, w, dist)
    dx = (b - a) / medium_hete.N_MARCH
    t = torch.exp(-(vol.sigma_t * dx * aux[..., 0]))
    in_h = med == vol.mat_id
    return torch.where(in_h[..., None],
                       _ValueOf.apply(march, t[..., None].expand_as(march)),
                       tr)


def sample_dist_scene(scene, med, lam, org, w, t_hit, rnd):
    """Scene-level free flight: homogeneous material media plus the
    heterogeneous grid (scene.vol) where present.  Same contract as
    :func:`sample_dist`; ``org``/``w`` locate the ray for the grid march:
    on the card the CUDA kernel (``ops/hete_cuda.py``), written into the
    homogeneous results at the grid's lanes (into copies, with
    :func:`grid_sample_graph`, where autograd needs the march), elsewhere
    the plain march."""
    scat, dist, wgt = sample_dist(scene.materials, med, lam, t_hit, rnd)
    if not scene.has_hete:
        return scat, dist, wgt
    vol = scene.vol
    if not org.is_cuda:
        return grid_sample_plain(vol, med, org, w, t_hit, rnd, scat, dist,
                                 wgt)
    graph = _needs_graph(vol, (org, w, t_hit, rnd, dist, wgt))
    out = (scat.clone(), dist.detach().clone(), wgt.detach().clone()) \
        if graph else (scat, dist, wgt)
    aux = torch.zeros(med.numel(), 3, device=med.device) if graph else None
    hete_cuda.march('sample', vol, _lanes(med), _lanes(org, (3,)),
                    _lanes(w, (3,)), _lanes(t_hit),
                    out[2].view(-1, wgt.shape[-1]), rnd=_lanes(rnd),
                    scat=out[0].view(-1), dist=out[1].view(-1), aux=aux)
    if graph:
        return grid_sample_graph(vol, med, org, w, t_hit, rnd,
                                 (scat, dist, wgt), out[:2],
                                 aux.view(*med.shape, 3))
    return out


def transmittance_scene(scene, med, lam, org, w, dist):
    """Scene-level transmittance along [0, dist] from org; the grid's
    lanes as in :func:`sample_dist_scene` (:func:`grid_transmit_graph`)."""
    tr = transmittance(scene.materials, med, lam, dist)
    if not scene.has_hete:
        return tr
    vol = scene.vol
    if not org.is_cuda:
        return grid_transmit_plain(vol, med, org, w, dist, tr)
    graph = _needs_graph(vol, (org, w, dist, tr))
    out = tr.detach().clone() if graph else tr
    aux = torch.zeros(med.numel(), 3, device=med.device) if graph else None
    hete_cuda.march('transmit', vol, _lanes(med), _lanes(org, (3,)),
                    _lanes(w, (3,)), _lanes(dist), out.view(-1, tr.shape[-1]),
                    aux=aux)
    if graph:
        return grid_transmit_graph(vol, med, org, w, dist, tr, out,
                                   aux.view(*med.shape, 3))
    return out


def hg_phase(g, cos_t):
    """Henyey-Greenstein phase function value (1/sr)."""
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-8)
    return (1.0 - g * g) / (4.0 * math.pi * denom * sqrt(denom))


def hg_sample(g, wi, r1, r2):
    """Sample an outgoing direction around the propagation direction wi.

    Returns (wo [N,3], pdf [N]); pdf equals the phase value (perfect
    importance sampling), isotropic for |g| ~ 0."""
    g = torch.as_tensor(g, dtype=torch.float32, device=wi.device)
    iso = torch.abs(g) < 1e-3
    g_safe = torch.where(iso, 0.5, g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * r1)
    cos_t_aniso = (1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    cos_t = torch.where(iso, 1.0 - 2.0 * r1,
                        torch.clamp(cos_t_aniso, -1.0, 1.0))
    sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    phi = 2.0 * math.pi * r2
    u, v = build_onb(wi)
    wo = (cos_t[..., None] * wi
          + (sin_t * torch.cos(phi))[..., None] * u
          + (sin_t * torch.sin(phi))[..., None] * v)
    return normalize(wo), hg_phase(g, cos_t)


# --- nested-media priority stack -------------------------------------------
# The reference resolves overlapping media with a per-path stack where the
# smallest shape id wins (_path_edge_medium, src/pathspace.c:80-115): a
# small fixed-depth sorted set of interior material ids per lane; push on
# entering transmission, pop on exiting; the current medium is the minimum
# id; empty slots sort to the top.

MED_STACK_DEPTH = 4
MED_EMPTY = 0x7fffffff


def stack_init(template):
    """Empty stack [N, D] shaped like ``template`` [N]."""
    return torch.full(template.shape + (MED_STACK_DEPTH,), MED_EMPTY,
                      dtype=torch.int64, device=template.device)


def stack_current(stack):
    """Active interior material id per lane (-1 = vacuum)."""
    m = torch.amin(stack, dim=-1)
    return torch.where(m == MED_EMPTY, -1, m)


def stack_push(stack, mat, do):
    """Insert ``mat`` where ``do``; on overflow the largest id (lowest
    priority) falls off."""
    entry = torch.where(do, mat, MED_EMPTY)
    ext = torch.cat([stack, entry[..., None]], dim=-1)
    ext = torch.sort(ext, dim=-1).values
    return ext[..., :MED_STACK_DEPTH]


def stack_pop(stack, mat, do):
    """Remove one instance of ``mat`` where ``do``."""
    hit = stack == mat[..., None]
    first = (torch.cumsum(hit.to(torch.int64), dim=-1) == 1) & hit
    rm = first & do[..., None]
    return torch.sort(torch.where(rm, MED_EMPTY, stack), dim=-1).values


def equiangular_sample(org, w, light_pos, t_max, rnd):
    """Equiangular distance sampling along [0, t_max] of the ray (org, w)
    toward a light point (Kulla/Fajardo; reference
    include/pathspace/equiangular.h): the scatter distance is drawn
    proportional to 1/d^2 to the light.

    Returns (t [N], pdf [N]) with pdf in distance measure (0 where the
    sampling degenerates: t_max <= 0)."""
    to_l = light_pos - org
    a = dot(to_l, w)                       # closest-approach parameter
    d2 = torch.clamp(dot(to_l, to_l) - a * a, min=1e-12)
    dd = sqrt(d2)
    th_a = torch.atan2(0.0 - a, dd)
    th_b = torch.atan2(t_max - a, dd)
    span = torch.clamp(th_b - th_a, min=1e-9)
    th = th_a + rnd * span
    t = a + dd * torch.tan(th)
    t = torch.minimum(torch.clamp(t, min=0.0), t_max)
    pdf = dd / (span * (d2 + (t - a) ** 2))
    ok = t_max > 0.0
    return torch.where(ok, t, 0.0), torch.where(ok, pdf, 0.0)
