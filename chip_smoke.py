"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the BVH8 traversal kernel from corona13_tpu_torch/csrc;
  3. kernel against plain: the CUDA kernel and its plain torch version on
     the same 589,824 rays (1024x576), closest-hit and any-hit, over the
     main path's cornell BVH, the in-repo 8198-triangle plane scene and a
     2^17-triangle random soup, with times from CUDA events;
  4. main path: render.render of testing.cornell_scene at 1024x576, mf=4,
     max_verts=6, NEE on, 4 spp, through the kernel (launch counts
     checked), plus the same path on the card against the CPU at 64x36;
  5. larger BVH: the plane scene rendered the same way at 2 spp;
  6. counters: the kernel with want_counters on the plane and soup BVHs at
     589,824 rays, closest-hit and any-hit, against the plain walk (equal
     pops per 1024-ray block), with its time with and without counters;
  7. golden gates: scene.load_scene of data/golden/scenes/0031_hete and
     0030_subsurf on the card, rendered at the JAX gates' settings
     (tests/test_golden.py:134-173) and held to their RMSE and mean bounds;
  8. media path at full width: both scenes at 1024x576, mf=4, max_verts=8,
     NEE and media on, 2 spp through render.render (launch counts checked),
     and 0031 again with equiangular=True;
  9. media path on the card against the CPU: sample_paths of 0031_hete at
     64x40;
 10. the CLI: python -m corona13_tpu_torch on 0031_hete, 256x160, 2 spp.
The line before the last is a JSON record of the kernels; the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 1024, 576
N_RAYS = W * H
ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(ROOT, 'data', 'golden', 'scenes')


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f'== {name}', flush=True)


def device_phase():
    phase('device')
    check(torch.cuda.is_available(), 'no CUDA device: this script needs a GPU')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}', flush=True)
    return smi.splitlines()[0]


def build_phase():
    from corona13_tpu_torch.ops import trace_cuda
    phase('build')
    t0 = time.time()
    trace_cuda.build()
    print(f'built corona13_tpu_torch/csrc/traverse_tris.cu for sm_90a in '
          f'{time.time() - t0:.1f} s', flush=True)


# --- phase 3: kernel against plain ------------------------------------------

def _soup(n, seed):
    """n random triangles, centres uniform in [-50, 50]^3, edges up to 2."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-50, 50, (n, 3)).astype(np.float32)
    e = g.uniform(-2.0, 2.0, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def _ray_sets(geom, scene, dev, seed):
    """Camera-like rays (the scene camera through every pixel) and
    bounce-like rays (cosine-free uniform directions from the camera
    rays' hit points), plus shadow segments toward random points."""
    from corona13_tpu_torch.models import camera as camera_mod
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.utils.math import normalize, ray_offset
    g = torch.Generator(device='cpu').manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g).to(dev)
    pix = torch.arange(N_RAYS, device=dev)
    pi = (pix % W).float() + u(N_RAYS)
    pj = (pix // W).float() + u(N_RAYS)
    org, d, _, _ = camera_mod.sample(scene.camera, W, H, pi, pj, u(N_RAYS),
                                     u(N_RAYS), torch.zeros(N_RAYS, device=dev))
    hit = trace_mod.intersect(geom, org, d)
    x = org + torch.where(hit.valid, hit.t, 1.0)[:, None] * d
    d2 = normalize(torch.randn(N_RAYS, 3, generator=g).to(dev))
    org2 = ray_offset(x, d2)
    target = x + 5.0 * normalize(torch.randn(N_RAYS, 3, generator=g).to(dev))
    to_t = target - org2
    dist = torch.linalg.norm(to_t, dim=-1)
    sets = {
        'camera': (org, d, torch.full_like(hit.prim, -1)),
        'bounce': (org2, d2, hit.prim),
        'shadow': (org2, to_t / dist[:, None], hit.prim, dist * 0.999),
    }
    return sets


def _soup_sets(dev, seed):
    """Rays into the soup: from a far eye, from random inner points, and
    8-unit shadow segments between inner points."""
    from corona13_tpu_torch.utils.math import normalize
    g = torch.Generator(device='cpu').manual_seed(seed)
    eye = torch.tensor([0.0, 0.0, -150.0])
    look = normalize(torch.randn(N_RAYS, 3, generator=g) * 0.2
                         + torch.tensor([0.0, 0.0, 1.0]))
    inner = (torch.rand(N_RAYS, 3, generator=g) - 0.5) * 90.0
    dirs = normalize(torch.randn(N_RAYS, 3, generator=g))
    far = inner + 8.0 * normalize(torch.randn(N_RAYS, 3, generator=g))
    none = torch.full((N_RAYS,), -1, dtype=torch.int64)
    to_t = far - inner
    dist = torch.linalg.norm(to_t, dim=-1)
    cpu = {
        'camera': (eye.expand(N_RAYS, 3).contiguous(), look, none),
        'bounce': (inner, dirs, none),
        'shadow': (inner, to_t / dist[:, None], none, dist),
    }
    return {k: tuple(a.to(dev) for a in v) for k, v in cpu.items()}


def _time_ms(fn, n_sets, reps):
    """Mean ms per call over reps calls cycling over n_sets input sets,
    between CUDA events, ending in a synchronize and a read-back."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    last = None
    for i in range(reps):
        last = fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    float(last[0].float().sum().item())
    return start.elapsed_time(end) / reps


def kernel_phase(dev):
    from corona13_tpu_torch import testing
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'kernel against plain, {N_RAYS} rays per call')
    cornell = scene_mod.fit_film(testing.cornell_scene(device=dev), W, H)
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    t0 = time.time()
    soup = trace_mod.make_device_geometry(tri_v=_soup(1 << 17, 7), device=dev)
    print(f'soup BVH (131072 triangles) built in {time.time() - t0:.1f} s',
          flush=True)
    bvhs = {'cornell': (cornell.geom, _ray_sets(cornell.geom, cornell, dev, 1),
                        _ray_sets(cornell.geom, cornell, dev, 2)),
            'plane': (plane.geom, _ray_sets(plane.geom, plane, dev, 3),
                      _ray_sets(plane.geom, plane, dev, 4)),
            'soup': (soup, _soup_sets(dev, 5), _soup_sets(dev, 6))}
    results = {'closest': {}, 'any': {}}
    for bname, (geom, set_a, set_b) in bvhs.items():
        b = geom.tri_bvh
        print(f'{bname}: {geom.n_tris} triangles, {b.wbounds.shape[0]} wide '
              f'nodes, {b.leaf_packed.shape[0]} leaves', flush=True)
        for kind in ('camera', 'bounce', 'shadow'):
            any_hit = kind == 'shadow'
            key = 'any' if any_hit else 'closest'

            argsets = []
            for rays in (set_a, set_b):        # two input sets, varied
                o, d, ig, *tm = rays[kind]
                t = tm[0] if tm else torch.full((N_RAYS,), 3.4e38, device=dev)
                argsets.append((b.wbounds, b.wlinks, b.leaf_packed,
                                o.contiguous(), d.contiguous(), t.contiguous(),
                                ig.to(torch.int32).contiguous()))
            kern = lambda s: trace_cuda.traverse_tris(*argsets[s],
                                                      any_hit=any_hit)
            plain = lambda s: trace_cuda.traverse_tris_plain(*argsets[s],
                                                             any_hit=any_hit)
            k = [x.cpu().numpy() for x in kern(0)]
            p = [x.cpu().numpy() for x in plain(0)]
            ms = _time_ms(kern, 2, 20)
            plain_ms = _time_ms(plain, 2, 1)
            agree, err = _compare_hits(k, p, any_hit, f'{bname}/{kind}')
            slot_agree = float((k[4] == p[4]).mean()) if not any_hit \
                else agree
            hits = float((k[1] >= 0).mean())
            print(f'  {kind:6s} {"any" if any_hit else "closest"}-hit: '
                  f'hit share {hits:.4f}, prim agree {agree:.6f}, slot agree '
                  f'{slot_agree:.6f}, max |dt| {err:.3g}; kernel {ms:.3f} ms, '
                  f'plain {plain_ms:.1f} ms', flush=True)
            results[key][f'{bname}/{kind}'] = dict(
                ms=ms, plain_ms=plain_ms, agree=agree, max_abs_err=err,
                hit_share=hits)
    print('tolerance: prim and slot (any-hit: blocked) identical on >= 99.9% '
          'of rays, t within rtol 1e-6 where prim agrees', flush=True)
    return results, bvhs


def _compare_hits(k, p, any_hit, where):
    """Kernel against plain on (t, prim, u, v, slot) as phase 3 holds them;
    returns (prim agreement, max |dt| where prim agrees)."""
    if any_hit:
        agree = float(((k[1] >= 0) == (p[1] >= 0)).mean())
        slot_agree = agree
        err = float(np.abs((k[1] >= 0).astype(np.float32)
                           - (p[1] >= 0)).max())
    else:
        agree = float((k[1] == p[1]).mean())
        slot_agree = float((k[4] == p[4]).mean())
        both = (k[1] == p[1]) & (k[1] >= 0)
        err = float(np.abs(k[0][both] - p[0][both]).max()) if both.any() \
            else 0.0
        rel = float((np.abs(k[0][both] - p[0][both])
                     / np.abs(p[0][both])).max()) if both.any() else 0.0
        check(rel <= 1e-6, f'{where}: t rel err {rel}')
    check(agree >= 0.999 and slot_agree >= 0.999,
          f'{where}: kernel and plain agree on only {agree}')
    return agree, err


def counters_phase(bvhs):
    """want_counters at the main path's shapes.  The counters' own path is
    one launch per case with the counts reset before and read after; the
    comparisons with the plain walk and the timings come after it."""
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'counters: want_counters against plain, {N_RAYS} rays per call')
    cases = []
    for bname in ('plane', 'soup'):
        geom, set_a, set_b = bvhs[bname]
        b = geom.tri_bvh
        for kind in ('bounce', 'shadow'):
            argsets = []
            for rays in (set_a, set_b):
                o, d, ig, *tm = rays[kind]
                t = tm[0] if tm else torch.full((N_RAYS,), 3.4e38,
                                                device=o.device)
                argsets.append((b.wbounds, b.wlinks, b.leaf_packed,
                                o.contiguous(), d.contiguous(), t.contiguous(),
                                ig.to(torch.int32).contiguous()))
            cases.append((f'{bname}/{kind}', kind == 'shadow', argsets))
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    outs = [trace_cuda.traverse_tris(*a[0], any_hit=ah, want_counters=True)
            for _, ah, a in cases]
    torch.cuda.synchronize()
    launches = dict(trace_cuda.launches)
    print(f'counter launches {launches} (expected {len(cases)} counters)',
          flush=True)
    check(launches == {'closest': 0, 'any': 0, 'counters': len(cases)},
          f'counter launch counts {launches}')
    res = {}
    for (name, ah, argsets), out in zip(cases, outs):
        k = [x.cpu().numpy() for x in out]
        p = [x.cpu().numpy() for x in trace_cuda.traverse_tris_plain(
            *argsets[0], any_hit=ah, want_counters=True)]
        check(k[5].shape == (N_RAYS // 1024,), f'{name}: counter shape')
        blocks_eq = float(((k[5] == p[5]) & (k[6] == p[6])).mean())
        check(blocks_eq == 1.0, f'{name}: counters differ on '
              f'{1 - blocks_eq:.4%} of blocks')
        agree, err = _compare_hits(k, p, ah, name)
        # with and without counters in turns (with, without, without, with)
        on = lambda s: trace_cuda.traverse_tris(*argsets[s], any_hit=ah,
                                                want_counters=True)
        off = lambda s: trace_cuda.traverse_tris(*argsets[s], any_hit=ah)
        t_on, t_off = _time_ms(on, 2, 20), _time_ms(off, 2, 20)
        t_off += _time_ms(off, 2, 20)
        t_on += _time_ms(on, 2, 20)
        ms, ms_off = t_on / 2, t_off / 2
        plain_ms = _time_ms(lambda s: trace_cuda.traverse_tris_plain(
            *argsets[s], any_hit=ah, want_counters=True), 2, 1)
        per_ray = (k[5].sum() / N_RAYS, k[6].sum() / N_RAYS)
        print(f'  {name:13s} {"any" if ah else "closest"}-hit: blocks equal '
              f'{blocks_eq:.6f}, prim agree {agree:.6f}, max |dt| {err:.3g}; '
              f'pops per ray {per_ray[0]:.2f} inner / {per_ray[1]:.2f} leaf; '
              f'kernel {ms:.3f} ms with counters, {ms_off:.3f} ms without, '
              f'plain {plain_ms:.1f} ms', flush=True)
        res[name] = dict(ms=ms, ms_without=ms_off, plain_ms=plain_ms,
                         max_abs_err=err, agree=agree, blocks_equal=blocks_eq,
                         inner_per_ray=float(per_ray[0]),
                         leaf_per_ray=float(per_ray[1]))
    print('tolerance: iters and leafs equal on every block; hits as phase 3',
          flush=True)
    return res, launches


# --- phase 4/5: the main path ----------------------------------------------

def render_phase(name, scene, spp, gpu_name, max_verts=6, **kw):
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch.ops import trace_cuda
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=max_verts, mf=4,
                          use_nee=True, **kw)
    opts = ''.join(f', {k}={v}' for k, v in kw.items())
    phase(f'{name}: render.render {W}x{H}, mf=4, max_verts={max_verts}, NEE'
          f'{opts}, {spp} spp')
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    res = render_mod.render(scene, cfg, spp=spp, batch=1)
    launches = dict(trace_cuda.launches)
    img = res.image_xyz
    lit = float((img.sum(axis=-1) > 0).mean())
    print(f'image {img.shape}, mean {img.mean():.6g}, finite '
          f'{bool(np.isfinite(img).all())}, non-black share {lit:.4f}',
          flush=True)
    check(img.shape == (H, W, 3), f'image shape {img.shape}')
    check(np.isfinite(img).all(), 'non-finite pixels')
    check(img.mean() > 0, 'black image')
    per = spp * (cfg.max_verts - 1)
    print(f'kernel launches {launches} (expected {per} each)', flush=True)
    check(launches == {'closest': per, 'any': per, 'counters': 0},
          f'launch counts {launches}, expected {per} each')
    rays = 0
    pix = torch.arange(W * H, device=scene.device)
    for s in range(spp):
        rays += int(pt_mod.count_rays(scene, cfg, s, pix))
    print(f'{name}: {res.seconds / spp:.4f} s per frame, {rays} rays, '
          f'{rays / res.seconds / 1e6:.2f} Mrays/s on {gpu_name}', flush=True)
    return res, lit, launches, rays


def path_against_cpu(dev):
    """The whole path on the card (kernel) against the CPU (plain walk)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase('main path on the card against the CPU, 64x36')
    w, h = 64, 36
    cfg = pt_mod.PTConfig(width=w, height=h, max_verts=6, mf=4, use_nee=True)
    out = []
    for d in (dev, torch.device('cpu')):
        sc = scene_mod.fit_film(testing.cornell_scene(device=d), w, h)
        pix = torch.arange(w * h, device=d)
        out.append(pt_mod.sample_paths(sc, cfg, 5, pix)[0].cpu().numpy())
    close = float(np.isclose(out[0], out[1], rtol=1e-4, atol=1e-6)
                  .all(axis=-1).mean())
    print(f'paths agreeing at rtol 1e-4 / atol 1e-6: {close:.4f} '
          f'(bar 0.99); means {out[0].mean():.6g} vs {out[1].mean():.6g}',
          flush=True)
    check(close >= 0.99, f'card and CPU paths agree on only {close}')
    return close


# --- phases 7-10: the .nra2 scene path with participating media ------------

def _scene_path(name):
    return os.path.join(SCENES, name, 'test.nra2')


def _down(img, f):
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


def golden_phase(dev):
    """The JAX package's golden gates (tests/test_golden.py:134-173) on the
    card: same sizes, mf, max_verts, spp, fit_film and bounds."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.io import pfm as pfm_io
    from corona13_tpu_torch.samplers import pt as pt_mod
    out = {}
    for name, (w, h, mv, mf, spp, batch, down, max_rmse, max_mean) in {
            '0031_hete': (64, 40, 12, 2, 16, 8, 4, 0.06, 0.12),
            '0030_subsurf': (128, 80, 8, 4, 12, 4, 2, 0.2, 0.05)}.items():
        phase(f'golden gate {name}: {w}x{h}, mf={mf}, max_verts={mv}, '
              f'{spp} spp, media on')
        sc, _ = scene_mod.load_scene(_scene_path(name), device=dev)
        sc = scene_mod.fit_film(sc, w, h)
        cfg = pt_mod.PTConfig(width=w, height=h, max_verts=mv, mf=mf,
                              use_nee=True)
        res = render_mod.render(sc, cfg, spp=spp, batch=batch)
        gold = _down(pfm_io.read_pfm(os.path.join(
            ROOT, 'data', 'golden', f'{name}.pfm')), down)
        rmse = pfm_io.rmse(res.image_xyz, gold)
        mean_rel = abs(res.image_xyz.mean() - gold.mean()) / gold.mean()
        print(f'{name}: RMSE {rmse:.5f} (bound {max_rmse}), mean off by '
              f'{mean_rel:.4f} (bound {max_mean}), image mean '
              f'{res.image_xyz.mean():.6g} vs golden {gold.mean():.6g}',
              flush=True)
        check(np.isfinite(res.image_xyz).all(), f'{name}: non-finite pixels')
        check(rmse < max_rmse, f'{name}: RMSE {rmse} >= {max_rmse}')
        check(mean_rel < max_mean, f'{name}: mean off by {mean_rel}')
        out[name] = dict(rmse=float(rmse), mean_rel=float(mean_rel))
    return out


def media_paths_phase(dev, card):
    """Both media scenes at full width through render.render, and 0031
    with equiangular volume NEE (its grid interior opts out of it); the
    rates are printed with the card's name and power limit."""
    from corona13_tpu_torch import scene as scene_mod
    out = {}
    for name, spp, kw in (('0031_hete', 2, {}), ('0030_subsurf', 2, {}),
                          ('0031_hete', 2, {'equiangular': True})):
        sc, _ = scene_mod.load_scene(_scene_path(name), device=dev)
        sc = scene_mod.fit_film(sc, W, H)
        key = name + ('/equiangular' if kw else '')
        res, lit, launches, rays = render_phase(
            f'{key} ({sc.geom.n_tris} triangles)', sc, spp, card,
            max_verts=8, media=True, **kw)
        out[key] = dict(frame_s=res.seconds / spp, rays=rays,
                        mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                        mean=float(res.image_xyz.mean()))
    return out


def media_against_cpu(dev):
    """sample_paths of 0031_hete on the card (kernel) against the CPU."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase('media path on the card against the CPU, 0031_hete 64x40')
    w, h = 64, 40
    cfg = pt_mod.PTConfig(width=w, height=h, max_verts=8, mf=4, use_nee=True,
                          media=True)
    out = []
    for d in (dev, torch.device('cpu')):
        sc, _ = scene_mod.load_scene(_scene_path('0031_hete'), device=d)
        sc = scene_mod.fit_film(sc, w, h)
        pix = torch.arange(w * h, device=d)
        out.append(pt_mod.sample_paths(sc, cfg, 5, pix)[0].cpu().numpy())
    close = float(np.isclose(out[0], out[1], rtol=1e-4, atol=1e-6)
                  .all(axis=-1).mean())
    lit = float((out[1] > 0).any(axis=-1).mean())
    print(f'paths agreeing at rtol 1e-4 / atol 1e-6: {close:.4f} (bar 0.99); '
          f'means {out[0].mean():.6g} vs {out[1].mean():.6g}; paths with '
          f'signal {lit:.4f}', flush=True)
    check(close >= 0.99, f'card and CPU media paths agree on only {close}')
    check(lit > 0.05, f'only {lit} of the paths carry signal')
    return close


def cli_phase():
    from corona13_tpu_torch.io import pfm as pfm_io
    phase('CLI: python -m corona13_tpu_torch 0031_hete -s 2 -w 256 -h 160 '
          '--media')
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'hete')
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, '-m', 'corona13_tpu_torch',
             'data/golden/scenes/0031_hete/test.nra2', '-s', '2', '-w', '256',
             '-h', '160', '--media', '-x', out], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        print(p.stdout.strip(), flush=True)
        check(p.returncode == 0, f'CLI exited {p.returncode}: {p.stderr[-2000:]}')
        img = pfm_io.read_pfm(out + '_fb00.pfm')
        print(f'CLI: {time.time() - t0:.1f} s, image {img.shape}, mean '
              f'{img.mean():.6g}, finite {bool(np.isfinite(img).all())}',
              flush=True)
        check(img.shape == (160, 256, 3), f'CLI image shape {img.shape}')
        check(np.isfinite(img).all() and img.mean() > 0, 'CLI image not finite')
    return float(img.mean())


def main():
    smi = device_phase()
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    dev = torch.device('cuda')
    gpu = torch.cuda.get_device_name(0)
    build_phase()
    kres, bvhs = kernel_phase(dev)

    cornell = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                       device=dev), W, H)
    res, lit, launches, rays = render_phase('cornell', cornell, 4, gpu)
    check(lit >= 0.95, f'only {lit} of the pixels are lit')
    path_close = path_against_cpu(dev)

    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    res2, lit2, launches2, rays2 = render_phase('plane (8198 triangles)', plane,
                                                2, gpu)
    cres, claunches = counters_phase(bvhs)
    del bvhs
    gold = golden_phase(dev)
    media = media_paths_phase(dev, smi)
    media_close = media_against_cpu(dev)
    cli_mean = cli_phase()

    def entry(key, name):
        # the main path's shapes: cornell BVH, 589,824 bounce / shadow rays
        m = kres[key]['cornell/shadow' if key == 'any' else 'cornell/bounce']
        return {'name': name, 'route': 'cuda',
                'source': 'corona13_tpu_torch/csrc/traverse_tris.cu',
                'replaces': 'corona13_tpu/ops/trace_pallas.py:284',
                'launches': launches[key], 'max_abs_err': m['max_abs_err'],
                'ms': m['ms'], 'plain_ms': m['plain_ms']}
    m = cres['plane/bounce']     # the counters at a real BVH's bounce rays
    counters = {'name': 'traverse_tris counters', 'route': 'cuda',
                'source': 'corona13_tpu_torch/csrc/traverse_tris.cu',
                'replaces': 'corona13_tpu/ops/trace_pallas.py:284',
                'launches': claunches['counters'],
                'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                'plain_ms': m['plain_ms']}
    print(json.dumps({'device': smi, 'kernel_cases': kres,
                      'counter_cases': cres, 'golden': gold, 'render': {
        'cornell': {'frame_s': res.seconds / 4, 'rays': rays,
                    'mrays_per_s': rays / res.seconds / 1e6,
                    'lit_share': lit, 'paths_vs_cpu': path_close},
        'plane': {'frame_s': res2.seconds / 2, 'rays': rays2,
                  'mrays_per_s': rays2 / res2.seconds / 1e6,
                  'lit_share': lit2}, **media,
        '0031_hete/paths_vs_cpu': media_close, 'cli_mean': cli_mean}}),
        flush=True)
    print(json.dumps({'kernels': [entry('closest', 'traverse_tris closest-hit'),
                                  entry('any', 'traverse_tris any-hit'),
                                  counters]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': gpu,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
