# Frozen copy of corona13_tpu_torch/samplers/pt.py (lines 1-600) as of commit 2084081, for the benchmark's plain reference.
# Edited: ``round_state`` (a callable applied to the wavefront state after
# each bounce of the dense loop) threads through render_sample,
# sample_paths and _sample_paths_full, for the reduced-precision control.
# Dropped (no cell of the benchmark calls them): the compacted wavefront,
# the MLT samplers' primary-sample replay, envmap NEE, the ray counts,
# equiangular volume NEE and an emissive grid (refused at the start).
"""Wavefront path tracer: pt and ptdl (corona13_tpu/samplers/pt.py).

A fixed-size ray SoA advances through a Python loop over bounces with
masked (alive) lanes.  Vertex pdfs are tracked in vertex-area measure and
combined with the hero-wavelength balance heuristic; NEE is MIS-weighted
against BSDF extension (ptdl).  Every ``stop_gradient`` of the JAX
package is a ``.detach()`` at the same place.

The counter RNG, with or without participating media (``cfg.media``:
free flight through homogeneous interiors and the heterogeneous grid, HG
phase NEE and extension, the interior priority stack).  Moving scenes hand every trace call the path's shutter time.

``sample_paths`` and ``render_sample`` are differentiable in the scene's
float tensors that require grad (the detached-sampling estimator: sampled
directions, distances and pdfs are constants of the backward pass, and so
are the traversal kernels' hits).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import bsdf as bsdf_mod
from ..models import camera as camera_mod
from ..models import lights as lights_mod
from ..models import medium as medium_mod
from ..models import shading as shading_mod
from ..ops import rng
from ..ops.trace import INVALID_PRIM, MAX_DIST, intersect, occluded
from ..spectral import cie, rgb2spec
from ..utils.math import dot, ray_offset, sqrt


@dataclasses.dataclass(frozen=True)
class PTConfig:
    width: int = 1024
    height: int = 576
    max_verts: int = 16
    mf: int = 4
    use_nee: bool = True
    pointsampler: str = 'rand'
    seed: int = 0
    rr_start: int = 4   # path length after which throughput RR starts
    media: bool = False
    equiangular: bool = False

    def replace(self, **kw) -> 'PTConfig':
        return dataclasses.replace(self, **kw)


def _hero_mis(pdf_prod_prev, our_pdf, other_pdf):
    """Joint balance heuristic over hero lanes and (our, other)
    techniques (ptdl.c:78-88)."""
    our = our_pdf * pdf_prod_prev
    other = other_pdf * pdf_prod_prev
    denom = torch.sum(our + other, dim=-1, keepdim=True)
    denom = torch.where(denom > 0.0, denom, 1.0)
    return our / denom


def _lambert(n, w):
    return torch.abs(dot(n, w))


def _finite(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def sample_paths(scene, cfg: PTConfig, sample_idx, pixel_idx,
                 round_state=None):
    """Trace one path per entry of pixel_idx; returns spectral radiance
    accumulated per path [N, MF], the wavelengths [N, MF] and the image
    positions [N] (pix_i, pix_j)."""
    accum, lam, pi, pj, _ = _sample_paths_full(scene, cfg, sample_idx,
                                               pixel_idx,
                                               round_state=round_state)
    return accum, lam, pi, pj


def _sample_paths_full(scene, cfg: PTConfig, sample_idx, pixel_idx,
                       round_state=None):
    """The bounce loop.  pixel_idx [N] and sample_idx ([N] or scalar) are
    int64 ids in [0, 2^32).  Returns (accum, lam, pix_i, pix_j, state)."""
    if cfg.equiangular or (cfg.media and scene.has_vol_emission):
        raise ValueError('the plain reference covers neither equiangular '
                         'volume NEE nor an emissive grid')
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    mf = cfg.mf
    ps = cfg.pointsampler
    sidx = torch.broadcast_to(torch.as_tensor(sample_idx, device=dev),
                              pixel_idx.shape).to(torch.int64)

    def rnd(dim, salt=0):
        return rng.sample_dim(ps, pixel_idx, sidx, int(dim) + 101 * salt,
                              cfg.seed)

    # camera start (path_extend v==0 branch, pathspace.c:211-247)
    jx = rnd(rng.Dim.IMAGE_X)
    jy = rnd(rng.Dim.IMAGE_Y)
    pix_i = (pixel_idx % cfg.width).to(torch.float32) + jx
    pix_j = (pixel_idx // cfg.width).to(torch.float32) + jy
    lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), mf)
    cam = scene.camera
    time = rnd(rng.Dim.TIME) * torch.clamp(cam.exposure_time * 30.0, max=1.0)
    org, direction, cam_thr, cam_pdf_proj = camera_mod.sample(
        cam, cfg.width, cfg.height, pix_i, pix_j,
        rnd(rng.Dim.APERTURE_X), rnd(rng.Dim.APERTURE_Y), time)

    izero = torch.zeros(n, dtype=torch.int64, device=dev)
    thr0 = cam_thr[..., None].expand(n, mf)
    state = dict(
        # per-lane constants: they ride along with the wavefront
        pix=pixel_idx, sidx=sidx, lam=lam, time=time,
        org=org, dir=direction, thr=thr0,
        pdf_proj=cam_pdf_proj[..., None].expand(n, mf),
        pdf_prod=torch.ones_like(thr0),
        prev_n=camera_mod.cam_frame(cam, time)[2],
        prev_prim=izero + INVALID_PRIM,
        prev_connectable=izero > 0,   # camera vertex: no NEE to it
        alive=izero == 0,
        accum=torch.zeros_like(thr0),
        length=izero + 1,             # vertices so far (camera = 1)
        nrays=izero,                  # traced rays (extend + shadow)
        med_stack=medium_mod.stack_push(
            medium_mod.stack_init(izero), izero + max(scene.exterior_med, 0),
            izero == (0 if scene.exterior_med >= 0 else 1)),
    )
    for depth in range(cfg.max_verts - 1):
        state = _bounce(scene, cfg, state, depth)
        if round_state is not None:
            state = round_state(state)
    return state['accum'], lam, pix_i, pix_j, state


def _bounce(scene, cfg, state, depth):
    """One wavefront bounce: intersect, free flight through the current
    medium (cfg.media), shade, emitter/sky hit with hero MIS, area
    NEE from the surface or volume vertex, BSDF or phase extension,
    Russian roulette and the interior stack update."""
    alive = state['alive']
    org = state['org']
    d = state['dir']
    lam = state['lam']
    time = state['time']
    mats = scene.materials

    def rnd(dim, salt):
        return rng.sample_dim(cfg.pointsampler, state['pix'], state['sidx'],
                              int(dim) + 101 * salt, cfg.seed)

    cur_med = medium_mod.stack_current(state['med_stack'])
    # dead lanes trace with t_max = 0 and do no traversal work
    hit = intersect(scene.geom, org, d, ignore_prim=state['prev_prim'],
                    t_max=torch.where(alive, MAX_DIST, 0.0), time=time)
    nrays = state['nrays'] + alive.to(torch.int64)

    # free flight through the interior medium (path_propagate's
    # shader_vol_sample step, pathspace.c:697-740)
    if cfg.media:
        r_free = rnd(rng.Dim.FREE_PATH, 1 + depth)
        scat, vdist, w_med = medium_mod.sample_dist_scene(
            scene, cur_med, lam, org, d, hit.t, r_free)
        scat = scat & alive
        thr_in = state['thr'] * torch.where(alive[..., None], _finite(w_med),
                                            1.0)
    else:
        scat = torch.zeros_like(alive)
        vdist = hit.t
        thr_in = state['thr']
    valid = hit.valid & alive & ~scat
    # escaped rays park at a finite 1 km like the reference's envmap vertices
    t_park = torch.where(hit.valid, hit.t, 1e4)

    x = org + t_park[..., None] * d
    sp = shading_mod.prepare(scene, hit, x, d, lam)

    # geometric term of this segment (path_G, pathspace.c:59-69)
    g = (_lambert(state['prev_n'], d) * _lambert(sp.n, d)
         / torch.clamp(hit.t * hit.t, min=1e-20))
    pdf_area = state['pdf_proj'] * g[..., None]
    if cfg.media:
        # free-flight distance pdfs enter the vertex pdf (sigma_t*T at a
        # scatter vertex, the survival T at the surface)
        st_med = medium_mod.sigma_t(mats, cur_med, lam)
        d_eff = torch.clamp(torch.where(scat, vdist, hit.t), max=1e4)
        tr_pdf = torch.exp(-st_med * d_eff[..., None])
        pdf_area = torch.where(scat[..., None], st_med * tr_pdf,
                               pdf_area * tr_pdf)
        if scene.has_hete:
            # the grid's flat extinction cancels in the normalised hero-MIS
            # products: the JAX package carries 1 (a known reference
            # defect, ROADMAP Queue 3), reproduced here
            in_h = cur_med == scene.vol.mat_id
            pdf_area = torch.where((in_h & scat)[..., None], 1.0, pdf_area)
            pdf_area = torch.where((in_h & ~scat)[..., None],
                                   state['pdf_proj'] * g[..., None], pdf_area)
    pdf_area = _finite(pdf_area)

    # environment hit: escaped rays collect sky radiance (hero MIS only)
    missed = alive & ~hit.valid & ~scat
    sky = lights_mod.sky_eval(scene, d, lam)
    w_sky = _hero_mis(state['pdf_prod'], state['pdf_proj'],
                      torch.zeros_like(state['pdf_proj']))
    w_sky = _finite(w_sky).detach()
    accum_sky = torch.where(missed[..., None], thr_in * sky * w_sky, 0.0)

    # emitter hit (ptdl.c:117-125 / pt.c:44-49)
    le = lights_mod.eval_vertex(sp.em, sp.roughness, sp.gn, d)
    emits = valid & torch.any(le > 0.0, dim=-1)
    if cfg.use_nee and depth > 0:
        nee_w = lights_mod.nee_pdf_area(scene.lights, hit.prim)
        nee_w = torch.where(state['prev_connectable'], nee_w, 0.0)
    else:
        nee_w = torch.zeros_like(hit.t)
    w = _hero_mis(state['pdf_prod'], pdf_area, nee_w[..., None])
    w = _finite(w).detach()
    accum = state['accum'] + torch.where(emits[..., None], thr_in * le * w,
                                         0.0) + accum_sky

    # update the hero pdf product with this vertex (renormalized)
    pdf_prod = state['pdf_prod'] * pdf_area
    pp_norm = torch.amax(pdf_prod, dim=-1, keepdim=True)
    pdf_prod = pdf_prod / torch.where(pp_norm > 0.0, pp_norm, 1.0)

    # volume scatter vertex and its phase function
    if cfg.media:
        xv = org + vdist[..., None] * d
        g_hg = mats.med_g[torch.clamp(cur_med, min=0)]
        x_nee = torch.where(scat[..., None], xv, x)
    else:
        xv = x
        g_hg = torch.zeros_like(hit.t)
        x_nee = x

    # next event estimation (nee.h:87-243), surface and volume vertices
    if cfg.use_nee and scene.lights.n_lights > 0:
        ls = lights_mod.sample_nee(
            scene.lights, scene.geom, x_nee,
            rnd(rng.Dim.NEE_LIGHT2, 10 + depth),
            rnd(rng.Dim.NEE_X, 10 + depth),
            rnd(rng.Dim.NEE_Y, 10 + depth))
        to_l = ls['pos'] - x_nee
        dist = sqrt(torch.clamp(dot(to_l, to_l), min=1e-20))
        wo = to_l / dist[..., None]
        cos_l = -dot(ls['gn'], wo)
        lmat = torch.clamp(scene.prim_shader[torch.clamp(ls['prim'], min=0)],
                           0, mats.kind.shape[0] - 1)
        edf = lights_mod.phong_edf(mats.roughness[lmat], cos_l)
        l_em = mats.e_mul[lmat, None] * rgb2spec.eval_coeff(
            mats.e_coeff[lmat][..., None, :], lam)
        f, pdf_bsdf_proj = bsdf_mod.bsdf_eval_pdf(sp, d, wo,
                                                  kinds=scene.kinds_used)
        cos_near = _lambert(sp.n, wo)
        can_vertex = valid
        if cfg.media:
            # volume vertex: phase function instead of the BSDF and no
            # cosine at the scatter point (path_lambert, pathspace.c:45)
            ph = medium_mod.hg_phase(g_hg, dot(d, wo))
            f = torch.where(scat[..., None], ph[..., None], f)
            pdf_bsdf_proj = torch.where(scat[..., None], ph[..., None],
                                        pdf_bsdf_proj)
            cos_near = torch.where(scat, 1.0, cos_near)
            can_vertex = valid | scat
        g_nee = cos_near * torch.abs(cos_l) / torch.clamp(dist * dist,
                                                          min=1e-20)
        # the NEE vertex extends the path by one: respect max_verts
        can = can_vertex & (cos_l > 0.0) & torch.any(f > 0.0, dim=-1) & \
            (ls['pdf_area'] > 0.0) & (depth <= cfg.max_verts - 3)
        shadow_org = ray_offset(x_nee, wo)
        ignore = hit.prim
        if cfg.media:
            shadow_org = torch.where(scat[..., None], x_nee, shadow_org)
            ignore = torch.where(scat, INVALID_PRIM, ignore)
        blocked = occluded(scene.geom, shadow_org, wo,
                           torch.where(can, dist * (1.0 - 1e-3), 0.0),
                           ignore_prim=ignore, ignore_prim2=ls['prim'],
                           time=time)
        # count shadow rays that traverse (t_max > 0)
        nrays = nrays + can.to(torch.int64)
        can = can & ~blocked
        pdf_nee = ls['pdf_area'][..., None]
        pdf_nee_safe = torch.where(pdf_nee > 0.0, pdf_nee, 1.0)
        gfac = _finite((g_nee * edf)[..., None] / pdf_nee_safe)
        val = thr_in * f * gfac * l_em
        if cfg.media:
            # transmittance of the current interior along the shadow segment
            val = val * medium_mod.transmittance_scene(scene, cur_med, lam,
                                                       x_nee, wo, dist)
        # MIS vs bsdf extension (ptdl.c:141-145): pdfs in area measure
        w_nee = _hero_mis(pdf_prod, pdf_nee, pdf_bsdf_proj * g_nee[..., None])
        w_nee = _finite(w_nee).detach()
        accum = accum + torch.where(can[..., None], _finite(val) * w_nee, 0.0)

    # extend: sample the bsdf (path_extend, pathspace.c:190-207)
    r1 = rnd(rng.Dim.OMEGA_X, 1 + depth)
    r2 = rnd(rng.Dim.OMEGA_Y, 1 + depth)
    rm = rnd(rng.Dim.SCATTER_MODE, 1 + depth)
    wo, pdf_proj_new, bsdf_w, mode = bsdf_mod.bsdf_sample(
        sp, d, r1, r2, rm, kinds=scene.kinds_used)
    if cfg.media:
        # volume extension: an HG phase direction, weight phase/detach(pdf)
        # (primal 1; gradients w.r.t. the mean cosine flow)
        wo_v, pdf_v = medium_mod.hg_sample(g_hg, d, r1, r2)
        wo = torch.where(scat[..., None], wo_v, wo)
        pdf_proj_new = torch.where(scat[..., None], pdf_v[..., None],
                                   pdf_proj_new)
        ph_v = medium_mod.hg_phase(g_hg, dot(wo_v.detach(), d.detach()))
        w_v = ph_v / torch.clamp(pdf_v.detach(), min=1e-20)
        bsdf_w = torch.where(scat[..., None], w_v[..., None], bsdf_w)
        mode = torch.where(scat, bsdf_mod.MODE_VOLUME | bsdf_mod.MODE_DIFFUSE,
                           mode)
    # detached-sampling estimator: sampled directions and pdfs are
    # constants of the backward pass
    wo = wo.detach()
    pdf_proj_new = _finite(pdf_proj_new).detach()
    bsdf_w = _finite(bsdf_w)
    thr = thr_in * bsdf_w
    still = (valid | scat) & torch.any(thr > 0.0, dim=-1) & \
        torch.any(pdf_proj_new > 0.0, dim=-1)

    # russian roulette by throughput ratio once paths are long enough
    new_len = state['length'] + 1
    thr0 = state['thr'][..., 0]
    ratio = torch.where(thr0 > 0.0,
                        thr[..., 0] / torch.clamp(thr0, min=1e-30), 0.0)
    p_survive = torch.clamp(ratio, 0.05, 1.0).detach()
    do_rr = new_len > cfg.rr_start
    rrnd = rnd(rng.Dim.RUSSIAN_R, 1 + depth)
    survive = ~do_rr | (rrnd < p_survive)
    thr = torch.where((do_rr & survive)[..., None],
                      thr / p_survive[..., None], thr)
    still = still & survive
    connectable = (mode & (bsdf_mod.MODE_DIFFUSE | bsdf_mod.MODE_GLOSSY)) > 0

    new_org = ray_offset(x, wo)
    new_prev_n = sp.n
    new_prev_prim = hit.prim
    new_med = state['med_stack']
    if cfg.media:
        # interior transitions on transmission through the priority stack
        # (_path_edge_medium, pathspace.c:80-115): entering pushes the
        # shape's interior, exiting pops it
        mat = torch.clamp(scene.prim_shader[torch.clamp(hit.prim, min=0)], 0,
                          mats.kind.shape[0] - 1)
        has_med = mats.med_enabled[mat] & valid
        transmitted = (mode & bsdf_mod.MODE_TRANSMIT) > 0
        new_med = medium_mod.stack_push(new_med, mat,
                                        has_med & transmitted & ~sp.inside)
        new_med = medium_mod.stack_pop(new_med, mat,
                                       has_med & transmitted & sp.inside)
        new_org = torch.where(scat[..., None], xv, new_org)
        # volume vertices have no cosine: prev_n = wo makes the next
        # segment's near-lambert exactly 1 (path_lambert convention)
        new_prev_n = torch.where(scat[..., None], wo, new_prev_n)
        new_prev_prim = torch.where(scat, INVALID_PRIM, new_prev_prim)

    new_state = dict(
        org=new_org, dir=wo, thr=thr, pdf_proj=pdf_proj_new,
        pdf_prod=pdf_prod, prev_n=new_prev_n, prev_prim=new_prev_prim,
        prev_connectable=connectable, alive=still, accum=accum,
        length=new_len, nrays=nrays, med_stack=new_med)
    # dead lanes keep their state; accum and ray counts take the new
    # values; the per-lane constants ride along unchanged
    out = dict(state)
    for k, new in new_state.items():
        if k in ('accum', 'nrays'):
            out[k] = new
        else:
            m = alive.reshape(alive.shape + (1,) * (new.dim() - 1))
            out[k] = torch.where(m, new, state[k])
    return out


def render_sample(scene, cfg: PTConfig, sample_idx: int, batch: int = 1,
                  round_state=None):
    """One launch of ``batch`` progressions (1 jittered path per pixel per
    progression, sample indices sample_idx .. sample_idx+batch-1); returns
    the XYZ splat image [H, W, 3] (unnormalized accumulation)."""
    from ..ops import splat as splat_mod
    dev = scene.device
    n = cfg.width * cfg.height
    pixel_idx = torch.arange(n, dtype=torch.int64, device=dev).repeat(batch)
    sidx = (sample_idx + torch.arange(batch, dtype=torch.int64, device=dev)
            ).repeat_interleave(n)
    accum, lam, pix_i, pix_j = sample_paths(scene, cfg, sidx, pixel_idx,
                                            round_state=round_state)
    accum = _finite(accum)
    xyz = cie.spectral_to_xyz(lam, accum)
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    jx = pix_i - torch.floor(pix_i)
    jy = pix_j - torch.floor(pix_j)
    return splat_mod.splat_pixel_aligned(fb, jx, jy, xyz, batch=batch)
