"""Bidirectional path tracer, wavefront, full multi-strategy MIS
(corona13_tpu/samplers/bdpt.py).

Both subpaths are traced as wavefront SoA loops whose per-vertex records
are kept as a Python list (one dict per vertex), and every (s, t)
connection is a dense pass over the whole wavefront.

Strategy set: s >= 0 light vertices x t >= 2 eye vertices, plus the t = 1
camera splats (a light-subpath vertex connected to a sampled aperture point
and splatted at its projected pixel through the general splat).  MIS
weights are computed jointly over the full set, t = 1 included.

Participating media (``cfg.media``): the interior-medium transmittance is
applied deterministically on every subpath edge and connection segment,
with the interior priority stack tracked per subpath.  In-scattering
vertices are not sampled on subpaths, so absorbing interiors match
pt/ptdl while scattering media lose the in-scattered part (a reference
defect, kept; ``render_sample`` warns).

MIS bookkeeping in vertex-area measure: each record stores
  * pdf_fwd_a: the area pdf of sampling this vertex from its predecessor;
  * pdf_rev_a: the area pdf of sampling the predecessor from this vertex
    (specular vertices reuse their forward pdf);
  * g_rev: the geometric term toward the predecessor,
and the per-connection weight is the balance heuristic over strategies and
hero-wavelength lanes, evaluated with the ratio recurrence P_{j+-1}/P_j so
that it stays O(1) in float32.

Every ``stop_gradient`` of the JAX package (the MIS weights) is a
``.detach()`` at the same place.  As in the JAX package, the trace calls
pass no shutter ``time``: subpaths see a moving scene at shutter open.

``render.render`` runs it with ``cfg.sampler == 'bdpt'``.  Spans
(``tracing.py``): ``bdpt.subpath`` (the subpaths' starts and each
bounce), ``bdpt.connect`` (one s = 0 or s >= 1, t >= 2 strategy),
``bdpt.camera`` (one t = 1 connection with its splat) and ``bdpt.splat``;
inside ``tracing.counting()`` each bounce of a subpath and each
connection with a shadow ray is counted.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from ..models import bsdf as bsdf_mod
from ..models import camera as camera_mod
from ..models import lights as lights_mod
from ..models import medium as medium_mod
from ..models import shading as shading_mod
from ..ops import rng
from ..ops import splat as splat_mod
from ..ops.trace import MAX_DIST, intersect, occluded
from ..spectral import cie, rgb2spec
from ..utils.math import dot, ray_offset, sqrt
from .pt import PTConfig, _finite, _lambert


def _connectable(sp):
    """Vertex supports connections: any non-dirac lobe (diffuse always;
    dielectric and metal only above the specular roughness threshold)."""
    rough = sp.roughness > bsdf_mod.GLOSSY_THR
    return (sp.kind == bsdf_mod.DIFFUSE) | \
        ((sp.kind == bsdf_mod.DIELECTRIC) & rough) | \
        ((sp.kind == bsdf_mod.METAL) & rough) | \
        (sp.kind == bsdf_mod.DIFFDIEL)


def _trace_subpath(scene, cfg, lam, org0, dir0, thr0, pdf_proj0, prev_n0,
                   prev_prim0, n_steps, rnd, salt_base):
    """Advance a subpath wavefront n_steps bounces; returns a list of
    n_steps per-vertex records (record i = subpath vertex i+1 counted from
    the start vertex), each a dict of sp, x, d_in, thr, pdf_fwd_a,
    pdf_rev_a, g_rev, valid, connectable, prim, med."""
    n = org0.shape[0]
    mf = cfg.mf
    izero = torch.zeros(n, dtype=torch.int64, device=org0.device)
    state = dict(org=org0, dir=dir0, thr=thr0,
                 pdf_proj=torch.broadcast_to(pdf_proj0, (n, mf)),
                 prev_n=prev_n0, prev_prim=prev_prim0,
                 alive=izero == 0,
                 med_stack=medium_mod.stack_push(
                     medium_mod.stack_init(izero),
                     izero + max(scene.exterior_med, 0),
                     izero == (0 if scene.exterior_med >= 0 else 1)))
    mats = scene.materials
    recs = []
    for depth in range(n_steps):
        tracing.count_bounce(state['alive'])
        with tracing.span('bdpt.subpath', {'depth': depth}):
            alive = state['alive']
            org = state['org']
            d = state['dir']
            cur_med = medium_mod.stack_current(state['med_stack'])
            hit = intersect(scene.geom, org, d, ignore_prim=state['prev_prim'],
                            t_max=torch.where(alive, MAX_DIST, 0.0))
            valid = hit.valid & alive
            t_park = torch.where(hit.valid, hit.t, 1e4)
            x = org + t_park[..., None] * d
            sp = shading_mod.prepare(scene, hit, x, d, lam)
            if cfg.media:
                # deterministic edge transmittance through the current interior
                tr = _finite(medium_mod.transmittance_scene(
                    scene, cur_med, lam, org, d, t_park))
                state = dict(state, thr=state['thr'] *
                             torch.where(alive[..., None], tr, 1.0))

            g = (_lambert(state['prev_n'], d) * _lambert(sp.n, d)
                 / torch.clamp(hit.t * hit.t, min=1e-20))
            pdf_fwd_a = _finite(state['pdf_proj'] * g[..., None])

            # extension sample
            r1 = rnd(rng.Dim.OMEGA_X, salt=salt_base + depth)
            r2 = rnd(rng.Dim.OMEGA_Y, salt=salt_base + depth)
            rm = rnd(rng.Dim.SCATTER_MODE, salt=salt_base + depth)
            wo, pdf_new, w, mode = bsdf_mod.bsdf_sample(sp, d, r1, r2, rm,
                                                        kinds=scene.kinds_used)
            specular = (mode & bsdf_mod.MODE_SPECULAR) > 0
            pdf_new = _finite(pdf_new)
            w = _finite(w)

            # reverse pdf toward the predecessor (the same G both ways)
            _, rev_proj = bsdf_mod.bsdf_eval_pdf(sp, -wo, -d,
                                                 kinds=scene.kinds_used)
            rev_proj = torch.where(specular[..., None], pdf_new,
                                   _finite(rev_proj))
            pdf_rev_a = _finite(rev_proj * g[..., None])

            recs.append(dict(sp=sp, x=x, d_in=d, thr=state['thr'],
                             pdf_fwd_a=pdf_fwd_a, pdf_rev_a=pdf_rev_a, g_rev=g,
                             valid=valid, connectable=_connectable(sp) & valid,
                             prim=hit.prim, med=cur_med))

            thr = state['thr'] * w
            still = valid & torch.any(thr > 0.0, dim=-1) & \
                torch.any(pdf_new > 0.0, dim=-1)
            new_med = state['med_stack']
            if cfg.media:
                # interior transitions on transmission (the priority stack)
                mat = torch.clamp(
                    scene.prim_shader[torch.clamp(hit.prim, min=0)],
                    0, mats.kind.shape[0] - 1)
                has_med = mats.med_enabled[mat] & valid
                transmitted = (mode & bsdf_mod.MODE_TRANSMIT) > 0
                new_med = medium_mod.stack_push(
                    new_med, mat, has_med & transmitted & ~sp.inside)
                new_med = medium_mod.stack_pop(
                    new_med, mat, has_med & transmitted & sp.inside)
            new = dict(org=ray_offset(x, wo), dir=wo, thr=thr,
                       pdf_proj=pdf_new, prev_n=sp.n, prev_prim=hit.prim,
                       alive=still, med_stack=new_med)
            state = {k: torch.where(
                alive.reshape(alive.shape + (1,) * (v.dim() - 1)), v, state[k])
                for k, v in new.items()}
    return recs


def _ratio(num, den):
    den_safe = torch.where(den > 0.0, den, 1.0)
    r = num / den_safe
    return torch.where((den > 0.0) & torch.isfinite(r), r, 0.0)


def _weight(denom):
    """The balance-heuristic weight 1 / sum over lanes of the strategy
    ratios, detached like the JAX package's stop_gradient."""
    w = _ratio(torch.ones_like(denom[..., :1]),
               torch.sum(denom, dim=-1, keepdim=True))
    return _finite(w).detach()


def render_sample(scene, cfg: PTConfig, sample_idx, batch: int = 1,
                  only=None, strategies=None):
    """One bdpt progression: returns the XYZ accumulation framebuffer
    [H, W, 3] (unnormalized, like pt.render_sample).

    ``only``: one strategy (s, t): compute just that connection (the MIS
    weights still span the full strategy set); the device half of bdpt1.

    ``strategies``: a frozenset of (s, t) restricting the estimator to that
    family; the MIS denominators then span exactly the restricted set, so
    the estimator stays unbiased (ptlt).

    The ``batch`` copies share their pixel and sample ids, as in the JAX
    package: they trace the same paths."""
    if cfg.media or scene.has_hete:
        import warnings
        warnings.warn('bdpt applies interior-medium transmittance '
                      '(absorption) on subpath edges and connections, but '
                      'samples no in-scattering vertices: scattering '
                      '(sigma_s > 0) media diverge from pt/ptdl; '
                      'absorbing interiors agree')
    dev = scene.device
    n = cfg.width * cfg.height * batch
    pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int64,
                             device=dev).repeat(batch)
    mf = cfg.mf
    ps = cfg.pointsampler
    mats = scene.materials
    only = None if only is None else tuple(only)

    NT = cfg.max_verts - 1    # eye surface vertices y_1 .. y_NT
    NL = max(cfg.max_verts - 2, 1)   # light vertices z_0 .. z_{NL-1}

    def in_set(s_, t_):
        """Strategy (s_, t_) is part of the estimator's set (and so of
        every MIS denominator)."""
        return strategies is None or (s_, t_) in strategies

    def compute(s_, t_):
        if only is not None:
            return only == (s_, t_)
        return in_set(s_, t_)

    def rnd(dim, salt=0):
        return rng.sample_dim(ps, pixel_idx, sample_idx,
                              int(dim) + 101 * salt, cfg.seed)

    def rnd_l(dim, salt=0):
        # decorrelated stream for the light subpath
        return rng.sample_dim(ps, pixel_idx, sample_idx,
                              int(dim) + 101 * salt, cfg.seed + 0x9e37)

    # --- eye subpath -----------------------------------------------------
    with tracing.span('bdpt.subpath'):
        jx = rnd(rng.Dim.IMAGE_X)
        jy = rnd(rng.Dim.IMAGE_Y)
        pix_i = (pixel_idx % cfg.width).to(torch.float32) + jx
        pix_j = (pixel_idx // cfg.width).to(torch.float32) + jy
        lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), mf)
        cam = scene.camera
        time = rnd(rng.Dim.TIME) * torch.clamp(cam.exposure_time * 30.0,
                                               max=1.0)
        org, d0, cam_thr, cam_pdf_proj = camera_mod.sample(
            cam, cfg.width, cfg.height, pix_i, pix_j,
            rnd(rng.Dim.APERTURE_X), rnd(rng.Dim.APERTURE_Y), time)
        cam_n = camera_mod.cam_frame(cam, time)[2]

    eye = _trace_subpath(
        scene, cfg, lam, org, d0, cam_thr[..., None].expand(n, mf),
        cam_pdf_proj[..., None], cam_n.expand(n, 3),
        torch.full((n,), -1, dtype=torch.int64, device=dev), NT, rnd,
        salt_base=1)
    # eye[m - 1] = record of eye vertex y_m (m = 1 .. NT)

    # --- light subpath ---------------------------------------------------
    with tracing.span('bdpt.subpath'):
        em = lights_mod.sample_emission(
            scene.lights, scene.geom, mats, scene.prim_shader, lam,
            rnd_l(rng.Dim.LIGHTSOURCE), rnd_l(rng.Dim.LIGHT_X),
            rnd_l(rng.Dim.LIGHT_Y), rnd_l(rng.Dim.EDF_X), rnd_l(rng.Dim.EDF_Y))
        pdf_pos = em['pdf_pos']                       # [N] area pdf of z_0
        pdf_pos_mf = pdf_pos[..., None].expand(n, mf)
        mat_l0 = scene.prim_shader[torch.clamp(em['prim'], min=0)]
        le_spec = (mats.e_mul[mat_l0, None] * rgb2spec.eval_coeff(
            mats.e_coeff[mat_l0][..., None, :], lam))
        rough_l0 = mats.roughness[mat_l0]
    light = _trace_subpath(
        scene, cfg, lam, ray_offset(em['pos'], em['dir']), em['dir'],
        em['thr'], torch.full((n, 1), 1.0 / math.pi, device=dev),  # diffuse EDF
        em['gn'], em['prim'], max(NL - 1, 1), rnd_l, salt_base=1)
    # light[m - 1] = record of light vertex z_m (m = 1 .. NL-1)

    accum = torch.zeros((n, mf), dtype=torch.float32, device=dev)
    ones = torch.ones((n, mf), dtype=torch.float32, device=dev)

    # MIS convention: the eye-side pdf of the camera-adjacent vertex folds
    # the aperture-area pdf 1/A in and the camera vertex carries no factor,
    # but the t = 1 technique samples its aperture point with pdf 1/A, so
    # every ratio crossing between t = 1 and t >= 2 reinstates that factor
    inv_ap_area = 1.0 / camera_mod.aperture_area(cam)

    # =====================================================================
    # s = 0: the eye path hits an emitter
    # =====================================================================
    for t in range(2, NT + 2):
        if not compute(0, t):
            continue
        with tracing.span('bdpt.connect', {'s': 0, 't': t}):
            k = t
            r = eye[t - 2]                           # emitter vertex y_{t-1}
            le = lights_mod.eval_vertex(r['sp'].em, r['sp'].roughness,
                                        r['sp'].gn, r['d_in'])
            emits = r['valid'] & torch.any(le > 0.0, dim=-1)

            pdfA_fwd = []   # pA_fwd[i], path index i = 0 (light end) .. k-2
            pdfA_rev = []
            conn = []
            pdfA_fwd.append(lights_mod.nee_pdf_area(scene.lights, r['prim'])
                            [..., None].expand(n, mf))
            pdfA_rev.append(r['pdf_fwd_a'])
            conn.append(emits)
            for i in range(1, k - 1):
                m = t - 1 - i                        # eye vertex index
                rm_ = eye[m - 1]
                if i == 1:
                    # diffuse-EDF direction pdf from the emitter toward y_{t-2}
                    pdfA_fwd.append((1.0 / math.pi) * r['g_rev'][..., None]
                                    * ones)
                else:
                    pdfA_fwd.append(eye[m]['pdf_rev_a'])
                pdfA_rev.append(rm_['pdf_fwd_a'])
                conn.append(rm_['connectable'])

            denom = ones
            rr = ones
            for j in range(1, k):
                rr = rr * _ratio(pdfA_fwd[j - 1], pdfA_rev[j - 1])
                if j > NL or (k - j) > NT + 1 or not in_set(j, k - j):
                    continue
                # j = k-1 is the t = 1 camera splat: the camera vertex is
                # always connectable and contributes its explicit aperture
                # pdf 1/A
                if j == k - 1:
                    denom = denom + torch.where(conn[j - 1][..., None],
                                                rr * inv_ap_area, 0.0)
                else:
                    ok = conn[j - 1] & conn[j]
                    denom = denom + torch.where(ok[..., None], rr, 0.0)
            w = _weight(denom)
            accum = accum + torch.where(emits[..., None], r['thr'] * le * w,
                                        0.0)

    # =====================================================================
    # s >= 1, t >= 2 connections
    # =====================================================================
    for s in range(1, NL + 1):
        for t in range(2, NT + 2):
            if not compute(s, t):
                continue
            k = s + t
            if k > cfg.max_verts:
                continue
            with tracing.span('bdpt.connect', {'s': s, 't': t}):
                ry = eye[t - 2]                      # eye endpoint y_{t-1}
                if s == 1:
                    z_x, z_n, z_prim = em['pos'], em['gn'], em['prim']
                    z_valid = pdf_pos > 0.0
                    z_conn = z_valid
                    z_thr = _ratio(ones, pdf_pos_mf)
                else:
                    rz = light[s - 2]                # light endpoint z_{s-1}
                    z_x, z_n, z_prim = rz['x'], rz['sp'].n, rz['prim']
                    z_valid = rz['valid']
                    z_conn = rz['connectable']
                    z_thr = rz['thr']

                to_z = z_x - ry['x']
                d2 = torch.clamp(dot(to_z, to_z), min=1e-20)
                dist = sqrt(d2)
                wdir = to_z / dist[..., None]        # y_end -> z_end
                cos_y = _lambert(ry['sp'].n, wdir)
                cos_z = _lambert(z_n, wdir)
                g_conn = cos_y * cos_z / d2

                f_y, p_y = bsdf_mod.bsdf_eval_pdf(ry['sp'], ry['d_in'], wdir,
                                                  kinds=scene.kinds_used)
                if s == 1:
                    cos_gn = dot(em['gn'], -wdir)  # emitted toward y
                    edf = lights_mod.phong_edf(rough_l0, cos_gn)
                    edf = torch.where(
                        (cos_gn > 0.0) & torch.isfinite(edf), edf, 0.0)
                    f_z = le_spec * edf[..., None]   # Le * EDF
                    p_z_fwd = torch.where((cos_gn > 0.0)[..., None],
                                          1.0 / math.pi, 0.0) * ones
                    z_ok = z_valid & (cos_gn > 0.0)
                else:
                    f_z, p_z_fwd = bsdf_mod.bsdf_eval_pdf(
                        rz['sp'], rz['d_in'], -wdir, kinds=scene.kinds_used)
                    z_ok = z_valid
                f_y = _finite(f_y)
                f_z = _finite(f_z)

                can = ry['valid'] & ry['connectable'] & z_ok & z_conn & \
                    torch.any(f_y > 0.0, dim=-1) & torch.any(f_z > 0.0, dim=-1)
                blocked = occluded(
                    scene.geom, ray_offset(ry['x'], wdir), wdir,
                    torch.where(can, dist * (1.0 - 1e-3), 0.0),
                    ignore_prim=ry['prim'], ignore_prim2=z_prim)
                live = can & ~blocked
                tracing.count_connect(s, t, can, live)
                can = live

                contrib = _finite(ry['thr'] * f_y * z_thr * f_z
                                  * g_conn[..., None])
                if cfg.media:
                    # transmittance of the eye endpoint's interior along the
                    # connection (boundary crossings are blocked by the
                    # visibility test, like pt's NEE)
                    tr_c = medium_mod.transmittance_scene(
                        scene, ry['med'], lam, ry['x'], wdir, dist)
                    contrib = contrib * _finite(tr_c)

                # ------- MIS: pA_fwd / pA_rev / conn along the full path -----
                pdfA_fwd = [None] * (k - 1)
                pdfA_rev = [None] * (k - 1)
                conn = [None] * (k - 1)
                for i in range(min(s, k - 1)):       # light side
                    if i == 0:
                        pdfA_fwd[0] = pdf_pos_mf * ones
                        conn[0] = pdf_pos > 0.0
                    else:
                        ri = light[i - 1]
                        pdfA_fwd[i] = ri['pdf_fwd_a']
                        conn[i] = ri['connectable']
                    if i == s - 1:
                        pdfA_rev[i] = p_y * g_conn[..., None]
                    elif i == s - 2:
                        rz_ = light[s - 2]
                        _, p = bsdf_mod.bsdf_eval_pdf(rz_['sp'], wdir,
                                                      -rz_['d_in'],
                                                      kinds=scene.kinds_used)
                        pdfA_rev[i] = _finite(p) * rz_['g_rev'][..., None]
                    else:
                        pdfA_rev[i] = light[i]['pdf_rev_a']
                for i in range(s, k - 1):            # eye side (m = k-1-i)
                    m = k - 1 - i
                    rm_ = eye[m - 1]
                    pdfA_rev[i] = rm_['pdf_fwd_a']
                    conn[i] = rm_['connectable']
                    if i == s:
                        pdfA_fwd[i] = p_z_fwd * g_conn[..., None]
                    elif i == s + 1:
                        _, p = bsdf_mod.bsdf_eval_pdf(ry['sp'], -wdir,
                                                      -ry['d_in'],
                                                      kinds=scene.kinds_used)
                        pdfA_fwd[i] = _finite(p) * ry['g_rev'][..., None]
                    else:
                        pdfA_fwd[i] = eye[m]['pdf_rev_a']

                denom = ones
                rr = ones                        # splice down: j = s-1 .. 0
                for j in range(s - 1, -1, -1):
                    rr = rr * _ratio(pdfA_rev[j], pdfA_fwd[j])
                    if (k - j) > NT + 1:
                        break
                    if not in_set(j, k - j):
                        continue
                    if j == 0:
                        denom = denom + rr       # unidirectional: always on
                    else:
                        ok = conn[j - 1] & conn[j]
                        denom = denom + torch.where(ok[..., None], rr, 0.0)
                rr = ones                        # splice up: j = s+1 .. k-1
                for j in range(s + 1, k):
                    rr = rr * _ratio(pdfA_fwd[j - 1], pdfA_rev[j - 1])
                    if j > NL:
                        break
                    if not in_set(j, k - j):
                        continue
                    # j = k-1: the t = 1 camera splat (camera side always on,
                    # explicit aperture pdf 1/A)
                    if j == k - 1:
                        denom = denom + torch.where(conn[j - 1][..., None],
                                                    rr * inv_ap_area, 0.0)
                    else:
                        ok = conn[j - 1] & conn[j]
                        denom = denom + torch.where(ok[..., None], rr, 0.0)

                w = _weight(denom)
                accum = accum + torch.where(can[..., None], contrib * w, 0.0)

    # =====================================================================
    # t = 1: light-subpath endpoint -> camera aperture splats (they land
    # anywhere on the film: the general splat, as in samplers/lt.py)
    # =====================================================================
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    for s in range(1, NL + 1):
        if not compute(s, 1):
            continue
        k = s + 1
        if k > cfg.max_verts:
            break
        with tracing.span('bdpt.camera', {'s': s}):
            if s == 1:
                rz = None
                z_x, z_prim = em['pos'], em['prim']
                z_valid = pdf_pos > 0.0
                z_conn = z_valid
            else:
                rz = light[s - 2]
                z_x, z_prim = rz['x'], rz['prim']
                z_valid = rz['valid']
                z_conn = rz['connectable']
            cc = camera_mod.connect(
                cam, cfg.width, cfg.height, z_x,
                rnd_l(rng.Dim.APERTURE_X, salt=70 + s),
                rnd_l(rng.Dim.APERTURE_Y, salt=70 + s), time)
            d_cam = cc['dir']                       # z -> aperture, unit
            cos_ap = -dot(d_cam, cc['cam_n'])       # the aperture faces z
            if s == 1:
                # emitter -> camera: f = Le * EDF, the weight carries 1/pdf_pos
                cos_l = dot(em['gn'], d_cam)
                edf = lights_mod.phong_edf(rough_l0, cos_l)
                edf = torch.where((cos_l > 0.0) & torch.isfinite(edf), edf,
                                  0.0)
                f_z = le_spec * edf[..., None]
                z_thr = _ratio(ones, pdf_pos_mf)
                cos_z = cos_l
            else:
                f_z, _ = bsdf_mod.bsdf_eval_pdf(rz['sp'], rz['d_in'], d_cam,
                                                kinds=scene.kinds_used)
                f_z = _finite(f_z)
                z_thr = rz['thr']
                cos_z = _lambert(rz['sp'].n, d_cam)
            g_conn = torch.abs(cos_z) * cos_ap / \
                torch.clamp(cc['dist'] * cc['dist'], min=1e-20)
            can = z_valid & z_conn & cc['valid'] & (cos_ap > 1e-6) & \
                torch.any(f_z > 0.0, dim=-1)
            blocked = occluded(
                scene.geom, ray_offset(z_x, d_cam), d_cam,
                torch.where(can, cc['dist'] * (1.0 - 1e-3), 0.0),
                ignore_prim=z_prim)
            live = can & ~blocked
            tracing.count_connect(s, 1, can, live)
            can = live
            # cc['weight'] = sensor / p_aperture
            contrib = _finite(z_thr * f_z * (cc['weight'] * g_conn)[..., None])
            if cfg.media:
                med_z = (torch.full((n,), scene.exterior_med,
                                    dtype=torch.int64, device=dev)
                         if s == 1 else rz['med'])
                tr_c = medium_mod.transmittance_scene(
                    scene, med_z, lam, z_x, d_cam, cc['dist'])
                contrib = contrib * _finite(tr_c)

            # ---- MIS over all strategies of length k (this one is j = k-1) --
            pdfA_fwd = [None] * (k - 1)
            pdfA_rev = [None] * (k - 1)
            conn = [None] * (k - 1)
            pdfA_fwd[0] = pdf_pos_mf * ones
            conn[0] = pdf_pos > 0.0
            for i in range(1, k - 1):
                ri = light[i - 1]
                pdfA_fwd[i] = ri['pdf_fwd_a']
                conn[i] = ri['connectable']
            # reverse pdf of the camera-adjacent vertex: the camera direction
            # pdf x G without the folded aperture pdf 1/A, consistent with this
            # technique's own camera-vertex pdf 1/A (carried in cc['weight'])
            cam_rev = (camera_mod.pdf_connect(cam, cos_ap)
                       * camera_mod.aperture_area(cam) * g_conn)
            pdfA_rev[s - 1] = _finite(cam_rev)[..., None] * ones
            if s >= 2:
                _, p = bsdf_mod.bsdf_eval_pdf(rz['sp'], -d_cam, -rz['d_in'],
                                              kinds=scene.kinds_used)
                pdfA_rev[s - 2] = _finite(p) * rz['g_rev'][..., None]
            for i in range(0, s - 2):
                pdfA_rev[i] = light[i]['pdf_rev_a']

            denom = ones
            rr = ones
            for j in range(s - 1, -1, -1):           # splice down to j = 0
                rr = rr * _ratio(pdfA_rev[j], pdfA_fwd[j])
                if (k - j) > NT + 1:
                    break
                if not in_set(j, k - j):
                    continue
                if j == 0:
                    denom = denom + rr           # unidirectional: always on
                else:
                    ok = conn[j - 1] & conn[j]
                    denom = denom + torch.where(ok[..., None], rr, 0.0)
            w = _weight(denom)
            val = _finite(torch.where(can[..., None], contrib * w, 0.0))
            fb = splat_mod.splat(fb, cc['pix_i'], cc['pix_j'],
                                 cie.spectral_to_xyz(lam, val))

    # --- splat (pixel-aligned like pt.render_sample) ---------------------
    with tracing.span('bdpt.splat'):
        xyz = cie.spectral_to_xyz(lam, _finite(accum))
        return splat_mod.splat_pixel_aligned(fb, jx, jy, xyz, batch=batch)
