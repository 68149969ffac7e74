"""Progressive photon mapping with a sorted cell grid
(corona13_tpu/samplers/ppm.py).

  * photon pass: light subpaths (emitter starts as in ``lt``) deposit one
    photon record per diffuse surface vertex;
  * build: every photon gets a cell id at cell size 2r, and one stable
    sort orders all record columns by it (the reference's kd-tree build
    becomes a sort); the first ``K_PER_CELL`` photons of each cell keep
    their power, rescaled by count / K, the rest are dropped;
  * gather: each eye vertex looks up the 8 cells of the 2x2x2 block around
    it with ``searchsorted`` and scans K photons per cell densely: fixed
    trip counts, no lane filtering and no host sync.

A photon carries its own hero wavelengths and power; the gather surface
is diffuse, so its albedo is evaluated at the photon's wavelengths.  Eye
paths collect emitter and sky hits directly and gather at their first
diffuse vertex, walking through specular chains; the radius shrinks per
progression with alpha = 0.7.

As in the JAX package, the photon pass and the eye walk trace without a
shutter ``time`` (a moving scene is seen at shutter open), and the pixel
ids are tiled over ``batch`` with one sample index, so batch copies trace
the same eye paths (reference defects, kept).
"""

from __future__ import annotations

import math

import torch

from ..models import bsdf as bsdf_mod
from ..models import camera as camera_mod
from ..models import lights as lights_mod
from ..models import shading as shading_mod
from ..ops import rng
from ..ops import splat as splat_mod
from ..ops.trace import MAX_DIST, intersect
from ..spectral import cie, rgb2spec
from ..utils.math import dot, ray_offset

ALPHA = 0.7          # progressive radius exponent
K_PER_CELL = 16      # photons scanned per cell (sorted-run cap)
GRID = 256           # cells per axis


def _scene_extent(scene):
    root = scene.geom.tri_bvh.nodes[0]
    return torch.max(root[3:6] - root[0:3])


def _masked(alive, new, old):
    return torch.where(alive.reshape(alive.shape + (1,) * (new.dim() - 1)),
                       new, old)


def photon_pass(scene, cfg, sample_idx, n_paths: int, n_bounces: int):
    """Trace ``n_paths`` light subpaths; returns the photon records (pos,
    wi, lam [MF], power [MF], valid), n_bounces * n_paths of them, path
    by path."""
    dev = scene.device
    path_idx = torch.arange(n_paths, dtype=torch.int64, device=dev)

    def rnd(dim, salt=0):
        return rng.sample_dim(cfg.pointsampler, path_idx, sample_idx,
                              int(dim) + 101 * salt, cfg.seed + 0x51ab)

    lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), cfg.mf)
    em = lights_mod.sample_emission(
        scene.lights, scene.geom, scene.materials, scene.prim_shader, lam,
        rnd(rng.Dim.LIGHTSOURCE), rnd(rng.Dim.LIGHT_X), rnd(rng.Dim.LIGHT_Y),
        rnd(rng.Dim.EDF_X), rnd(rng.Dim.EDF_Y))
    state = dict(org=ray_offset(em['pos'], em['dir']), dir=em['dir'],
                 thr=em['thr'], prev_prim=em['prim'],
                 alive=torch.ones(n_paths, dtype=torch.bool, device=dev))
    recs = []
    for depth in range(n_bounces):
        alive = state['alive']
        d = state['dir']
        hit = intersect(scene.geom, state['org'], d,
                        ignore_prim=state['prev_prim'],
                        t_max=torch.where(alive, MAX_DIST, 0.0))
        valid = hit.valid & alive
        x = state['org'] + torch.where(hit.valid, hit.t, 1e4)[..., None] * d
        sp = shading_mod.prepare(scene, hit, x, d, lam)
        recs.append(dict(pos=x, wi=d, power=state['thr'],
                         valid=(sp.kind == bsdf_mod.DIFFUSE) & valid))
        wo, pdf_new, w, _ = bsdf_mod.bsdf_sample(
            sp, d, rnd(rng.Dim.OMEGA_X, 1 + depth),
            rnd(rng.Dim.OMEGA_Y, 1 + depth),
            rnd(rng.Dim.SCATTER_MODE, 1 + depth), kinds=scene.kinds_used)
        w = torch.where(torch.isfinite(w), w, 0.0)
        thr = state['thr'] * w
        still = valid
        if depth >= 2:
            # throughput RR keeps photon powers bounded
            p_s = torch.clamp(w[..., 0], 0.05, 1.0)
            kill = rnd(rng.Dim.RUSSIAN_R, 1 + depth) > p_s
            thr = torch.where(kill[..., None], thr, thr / p_s[..., None])
            still = still & ~kill
        still = still & torch.any(thr > 0.0, dim=-1) & \
            torch.any(pdf_new > 0.0, dim=-1)
        new = dict(org=ray_offset(x, wo), dir=wo, thr=thr,
                   prev_prim=hit.prim, alive=still)
        state = {k: _masked(alive, new[k], state[k]) for k in state}
    # path-major: a depth-major order would make the stable cell sort keep
    # the low-bounce (high-power) photons first in every dense cell and
    # bias the count / K rescale upward; path order is uncorrelated with
    # power
    flat = {k: torch.stack([r[k] for r in recs], dim=1).flatten(0, 1)
            for k in recs[0]}
    flat['lam'] = lam.repeat_interleave(n_bounces, dim=0)
    return flat


def build_grid(photons, lo, cell):
    """Sort the photon records by 3-D cell id (stable: path order within a
    cell); returns (records [P, 6 + 2 MF]: pos, wi, lam, power with the
    K-per-cell cap applied, sorted cell ids [P] int64).  Dead photons are
    parked at cell GRID**3."""
    g = torch.clamp((photons['pos'] - lo) / cell, 0, GRID - 1).to(torch.int64)
    cid = g[:, 0] + GRID * (g[:, 1] + GRID * g[:, 2])
    cid = torch.where(photons['valid'], cid, GRID ** 3)
    cid_s, perm = torch.sort(cid, stable=True)
    cols = torch.cat([photons['pos'], photons['wi'], photons['lam'],
                      photons['power']], dim=1)[perm]
    mf = photons['lam'].shape[-1]
    # keep the first K photons of each sorted run and rescale them by
    # count / K: dense cells stay energy-correct
    start = torch.searchsorted(cid_s, cid_s, right=False)
    end = torch.searchsorted(cid_s, cid_s, right=True)
    cnt = (end - start).to(torch.float32)
    rank = torch.arange(cid_s.shape[0], device=cid_s.device) - start
    scale = torch.clamp(cnt / K_PER_CELL, min=1.0)
    power = torch.where((rank < K_PER_CELL)[..., None],
                        cols[:, 6 + mf:] * scale[..., None], 0.0)
    return torch.cat([cols[:, :6 + mf], power], dim=1), cid_s


def gather(scene, recs, cid_s, x, n_gather, mat, r, lo, cell, n_emitted):
    """Photon density estimate at gather points x [N, 3] with normals
    n_gather and material ids mat: sum_k albedo(lam_k)/pi * power_k /
    (pi r^2 N), over the K slots of the 8 cells around x.  Returns XYZ
    [N, 3]."""
    m = scene.materials
    mf = (recs.shape[1] - 6) // 2
    # clamped in float before the cast: lanes that do not gather may sit
    # at org + 1e4 d, outside the grid, and are masked by the caller
    g0 = torch.clamp(torch.floor((x - lo) / cell - 0.5), -1.0,
                     float(GRID)).to(torch.int64)
    d_mul = m.d_mul[mat][:, None]
    d_coeff = m.d_coeff[mat][..., None, :]
    acc = torch.zeros((x.shape[0], 3), dtype=torch.float32, device=x.device)
    r2 = r * r
    last = cid_s.shape[0] - 1
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                gx, gy, gz = (torch.clamp(g0[:, a] + o, 0, GRID - 1)
                              for a, o in enumerate((ox, oy, oz)))
                cid = gx + GRID * (gy + GRID * gz)
                start = torch.searchsorted(cid_s, cid)
                for k in range(K_PER_CELL):
                    idx = torch.clamp(start + k, max=last)
                    rec = recs[idx]
                    dp = rec[:, 0:3] - x
                    # a disc gather: only photons near the tangent plane,
                    # arriving at the gather surface's front
                    ok = (cid_s[idx] == cid) & \
                        (torch.sum(dp * dp, dim=-1) < r2) & \
                        (torch.abs(dot(dp, n_gather)) < 0.1 * r) & \
                        (dot(rec[:, 3:6], n_gather) < 0.0)
                    lam_p = rec[:, 6:6 + mf]
                    alb = d_mul * rgb2spec.eval_coeff(d_coeff, lam_p)
                    # each hero lane is a full estimate at its own
                    # wavelength: average them (spectral_to_xyz sums)
                    contrib = rec[:, 6 + mf:] * alb / (math.pi * mf)
                    acc = acc + torch.where(
                        ok[..., None], cie.spectral_to_xyz(lam_p, contrib),
                        0.0)
    return acc / (math.pi * r2 * n_emitted)


def render_sample(scene, cfg, sample_idx, batch: int = 1,
                  n_photon_paths: int = 0, radius: float = 0.0):
    """One PPM progression; returns the XYZ accumulation FB [H, W, 3].

    radius = 0 picks r_i = 2.5% of the scene extent * (i+1)^((ALPHA-1)/2)
    (the progressive shrink); n_photon_paths defaults to 2x the pixel
    count."""
    dev = scene.device
    n = cfg.width * cfg.height * batch
    pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int64,
                             device=dev).repeat(batch)
    mf = cfg.mf
    if n_photon_paths <= 0:
        n_photon_paths = 2 * cfg.width * cfg.height
    photons = photon_pass(scene, cfg, sample_idx, n_photon_paths,
                          max(cfg.max_verts - 1, 2))

    ext = _scene_extent(scene)
    if radius <= 0.0:
        i1 = torch.full((), float(sample_idx), device=dev) + 1.0
        r = 0.025 * ext * i1 ** ((ALPHA - 1.0) / 2.0)
    else:
        r = torch.full((), radius, device=dev)
    cell = 2.0 * r
    lo = scene.geom.tri_bvh.nodes[0][0:3]
    recs, cid_s = build_grid(photons, lo, cell)
    del photons

    def rnd(dim, salt=0):
        return rng.sample_dim(cfg.pointsampler, pixel_idx, sample_idx,
                              int(dim) + 101 * salt, cfg.seed)

    jx = rnd(rng.Dim.IMAGE_X)
    jy = rnd(rng.Dim.IMAGE_Y)
    pix_i = (pixel_idx % cfg.width).to(torch.float32) + jx
    pix_j = (pixel_idx // cfg.width).to(torch.float32) + jy
    lam, _ = cie.sample_lambda_hero(rnd(rng.Dim.LAMBDA), mf)
    time = rnd(rng.Dim.TIME) * torch.clamp(
        scene.camera.exposure_time * 30.0, max=1.0)
    org, d, cam_thr, _ = camera_mod.sample(
        scene.camera, cfg.width, cfg.height, pix_i, pix_j,
        rnd(rng.Dim.APERTURE_X), rnd(rng.Dim.APERTURE_Y), time)

    thr = cam_thr[..., None].expand(n, mf)
    accum_spec = torch.zeros((n, mf), dtype=torch.float32, device=dev)
    accum_xyz = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    prev_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    gathered = torch.zeros(n, dtype=torch.bool, device=dev)
    n_mats = scene.materials.kind.shape[0]
    # the eye walk: a specular chain with one gather at the first diffuse
    # vertex; emitter and sky hits collect directly
    for depth in range(min(cfg.max_verts - 1, 4)):
        hit = intersect(scene.geom, org, d, ignore_prim=prev_prim,
                        t_max=torch.where(alive, MAX_DIST, 0.0))
        valid = hit.valid & alive
        x = org + torch.where(hit.valid, hit.t, 1e4)[..., None] * d
        sp = shading_mod.prepare(scene, hit, x, d, lam)
        missed = alive & ~hit.valid
        sky = lights_mod.sky_eval(scene, d, lam)
        accum_spec = accum_spec + torch.where(missed[..., None], thr * sky,
                                              0.0)
        le = lights_mod.eval_vertex(sp.em, sp.roughness, sp.gn, d)
        emits = valid & torch.any(le > 0.0, dim=-1)
        accum_spec = accum_spec + torch.where(emits[..., None], thr * le, 0.0)
        diffuse = (sp.kind == bsdf_mod.DIFFUSE) & valid & ~gathered
        mat = torch.clamp(scene.prim_shader[torch.clamp(hit.prim, min=0)], 0,
                          n_mats - 1)
        n_g = torch.where(sp.inside[..., None], -sp.n, sp.n)
        xyz = gather(scene, recs, cid_s, x, n_g, mat, r, lo, cell,
                     n_photon_paths)
        # photon power is spectral radiance / pdf per emitted path; the eye
        # throughput averages its hero lanes
        w_eye = torch.mean(thr, dim=-1, keepdim=True)
        accum_xyz = accum_xyz + torch.where(diffuse[..., None], xyz * w_eye,
                                            0.0)
        gathered = gathered | diffuse
        # continue through specular and glossy vertices only
        wo, _, w, _ = bsdf_mod.bsdf_sample(
            sp, d, rnd(rng.Dim.OMEGA_X, 1 + depth),
            rnd(rng.Dim.OMEGA_Y, 1 + depth),
            rnd(rng.Dim.SCATTER_MODE, 1 + depth), kinds=scene.kinds_used)
        thr = thr * torch.where(torch.isfinite(w), w, 0.0)
        alive = valid & ~gathered & torch.any(thr > 0.0, dim=-1)
        org = ray_offset(x, wo)
        d = wo
        prev_prim = hit.prim

    # 1/mf for the directly collected part as well (hero lanes averaged)
    accum_xyz = accum_xyz + cie.spectral_to_xyz(lam, accum_spec / mf)
    accum_xyz = torch.where(torch.isfinite(accum_xyz), accum_xyz, 0.0)
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    return splat_mod.splat_pixel_aligned(fb, jx, jy, accum_xyz, batch=batch)
