"""Light tracer: paths start at emitters and connect every vertex to the
camera (corona13_tpu/samplers/lt.py).

A light-path SoA advances through a Python loop over bounces; each bounce
connects the current vertex to a sampled aperture point and splats the
contribution at the projected pixel through the general splat
(``ops/splat.splat``: light-tracing splats land anywhere on the film).

Per progression width*height light paths are traced; with the constant
thin-lens importance (``camera.connect``) the framebuffer normalizes like
the pt progressions, so lt and pt agree in expectation.

As in the JAX package, the trace calls pass no shutter ``time``: on a
moving scene the light paths see the geometry at shutter open, and only
the camera connection uses the sampled time (a reference defect, kept).
"""

from __future__ import annotations

import torch

from ..models import bsdf as bsdf_mod
from ..models import camera as camera_mod
from ..models import lights as lights_mod
from ..models import shading as shading_mod
from ..ops import rng
from ..ops import splat as splat_mod
from ..ops.trace import MAX_DIST, intersect, occluded
from ..spectral import cie, rgb2spec
from ..utils.math import dot, ray_offset
from .pt import PTConfig, _lambert


def render_sample(scene, cfg: PTConfig, sample_idx, batch: int = 1):
    """One lt progression (``batch`` progressions of light paths in one
    wavefront): returns the XYZ accumulation framebuffer [H, W, 3]."""
    dev = scene.device
    n = cfg.width * cfg.height * batch
    path_idx = torch.arange(n, dtype=torch.int64, device=dev)
    mf = cfg.mf
    ps = cfg.pointsampler
    mats = scene.materials

    def rnd(dim, salt=0):
        return rng.sample_dim(ps, path_idx, sample_idx, int(dim) + 101 * salt,
                              cfg.seed)

    lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), mf)
    time = rnd(rng.Dim.TIME) * torch.clamp(scene.camera.exposure_time * 30.0,
                                           max=1.0)

    em = lights_mod.sample_emission(
        scene.lights, scene.geom, mats, scene.prim_shader, lam,
        rnd(rng.Dim.LIGHTSOURCE), rnd(rng.Dim.LIGHT_X), rnd(rng.Dim.LIGHT_Y),
        rnd(rng.Dim.EDF_X), rnd(rng.Dim.EDF_Y))

    def connect(fb, x, f_fn, ignore, can, salt):
        """Splat the camera connection of vertices x; f_fn(dir_to_cam) ->
        (f [N, MF], cos_at_x [N])."""
        cc = camera_mod.connect(scene.camera, cfg.width, cfg.height, x,
                                rnd(rng.Dim.APERTURE_X, salt=salt),
                                rnd(rng.Dim.APERTURE_Y, salt=salt), time)
        f, cos_x = f_fn(cc['dir'])
        cos_ap = -dot(cc['dir'], cc['cam_n'])   # the aperture faces x
        ok = can & cc['valid'] & (cos_ap > 1e-6) & torch.any(f > 0.0, dim=-1)
        blocked = occluded(scene.geom, ray_offset(x, cc['dir']), cc['dir'],
                           torch.where(ok, cc['dist'] * (1.0 - 1e-3), 0.0),
                           ignore_prim=ignore)
        ok = ok & ~blocked
        g = (torch.abs(cos_x) * cos_ap
             / torch.clamp(cc['dist'] * cc['dist'], min=1e-20))
        val = f * (cc['weight'] * g)[..., None]
        val = torch.where(ok[..., None] & torch.isfinite(val), val, 0.0)
        xyz = cie.spectral_to_xyz(lam, val / mf)
        return splat_mod.splat(fb, cc['pix_i'], cc['pix_j'], xyz)

    # the light vertex itself (makes emitters visible): its "f" is
    # Le(dir) / pdf_pos; the cosine at the light is part of G
    def f_light(d_cam):
        cos_l = dot(em['gn'], d_cam)
        mat = scene.prim_shader[torch.clamp(em['prim'], min=0)]
        edf = lights_mod.phong_edf(mats.roughness[mat], cos_l)
        edf = torch.where((cos_l > 0.0) & torch.isfinite(edf), edf, 0.0)
        pdf_pos_safe = torch.where(em['pdf_pos'] > 0.0, em['pdf_pos'], 1.0)
        le = mats.e_mul[mat, None] * _e_spectrum(scene, mat, lam)
        return le * (edf / pdf_pos_safe)[..., None], cos_l

    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    fb = connect(fb, em['pos'], f_light, em['prim'], em['pdf_pos'] > 0.0,
                 salt=50)

    izero = torch.zeros(n, dtype=torch.int64, device=dev)
    state = dict(
        org=em['pos'], dir=em['dir'], thr=em['thr'], prev_prim=em['prim'],
        alive=(em['pdf_pos'] > 0.0) & torch.any(em['thr'] > 0.0, dim=-1),
        length=izero + 1)

    for depth in range(cfg.max_verts - 2):
        alive = state['alive']
        org = state['org']
        d = state['dir']
        hit = intersect(scene.geom, ray_offset(org, d), d,
                        ignore_prim=state['prev_prim'],
                        t_max=torch.where(alive, MAX_DIST, 0.0))
        valid = hit.valid & alive
        x = org + torch.where(hit.valid, hit.t, 1e4)[..., None] * d
        sp = shading_mod.prepare(scene, hit, x, d, lam)

        # connect this surface vertex to the camera
        def f_surf(d_cam):
            f, _ = bsdf_mod.bsdf_eval_pdf(sp, d, d_cam,
                                          kinds=scene.kinds_used)
            return state['thr'] * f, _lambert(sp.n, d_cam)
        fb = connect(fb, x, f_surf, hit.prim, valid, salt=60 + depth)

        # extend (adjoint transport through the same BSDFs: the dielectric
        # eta^2 radiance/importance asymmetry is left out, as in the JAX
        # package)
        r1 = rnd(rng.Dim.OMEGA_X, salt=1 + depth)
        r2 = rnd(rng.Dim.OMEGA_Y, salt=1 + depth)
        rm = rnd(rng.Dim.SCATTER_MODE, salt=1 + depth)
        wo, _, w, _ = bsdf_mod.bsdf_sample(sp, d, r1, r2, rm,
                                           kinds=scene.kinds_used)
        w = torch.where(torch.isfinite(w), w, 0.0)
        thr = state['thr'] * w
        still = valid & torch.any(thr > 0.0, dim=-1)
        new_len = state['length'] + 1
        # Russian roulette by throughput ratio, as in pt
        thr0 = state['thr'][..., 0]
        ratio = torch.where(thr0 > 0.0,
                            thr[..., 0] / torch.clamp(thr0, min=1e-30), 0.0)
        p_survive = torch.clamp(ratio, 0.05, 1.0).detach()
        do_rr = new_len > cfg.rr_start
        rrnd = rnd(rng.Dim.RUSSIAN_R, salt=1 + depth)
        survive = ~do_rr | (rrnd < p_survive)
        thr = torch.where((do_rr & survive)[..., None],
                          thr / p_survive[..., None], thr)
        still = still & survive

        new = dict(org=x, dir=wo, thr=thr, prev_prim=hit.prim, alive=still,
                   length=new_len)
        state = {k: torch.where(
            alive.reshape(alive.shape + (1,) * (v.dim() - 1)), v, state[k])
            for k, v in new.items()}
    return fb


def _e_spectrum(scene, mat, lam):
    return rgb2spec.eval_coeff(scene.materials.e_coeff[mat][..., None, :], lam)
