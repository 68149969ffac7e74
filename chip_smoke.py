"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the traversal kernels from corona13_tpu_torch/csrc
     with nvcc and prints the registers of each instantiation;
  3. kernel against plain: the CUDA kernel and its plain torch version on
     the same 589,824 rays (1024x576), closest-hit and any-hit, over the
     main path's cornell BVH, the in-repo 8198-triangle plane scene and a
     2^17-triangle random soup, with times from CUDA events; then the
     plane and soup bounce and shadow rays again with the lanes dead
     (t_init = 0) that pt.alive_profile finds dead at bounces 2 and 4 of
     the plane scene, and once with every lane dead; every case launched
     twice and held bit-identical; then intersect/occluded as callers see
     them (ms per call, CUDA launches per call) on cornell (one triangle
     launch, one dense sphere launch, no torch launch) and plane;
  3b. the forms that replace XLA's skip-link _traverse, each against its
     plain version at 589,824 rays, closest-hit and any-hit, with dead
     lanes, ignore ids and (a second comparison) a running hit carried in:
     the wide walk with the moving-triangle policy (2^17 triangles, random
     ray times; the other forms get no time, as in trace.intersect), the
     sphere and the line policy (2^16 prims each), the deep walk on the
     triangle soup's tree without its wide layout and the skip-link walk
     on the same tree laid out as over the deep stack's limit, both bit
     for bit, and the dense list on cornell's one sphere and on 64 lines;
     two launches bit-identical;
     the moving form bit-equal to its plain walk on every ray, fresh and
     carried; then trace.intersect / trace.occluded on geometries that route to
     the forms no render below reaches (launch counts asserted);
  3c. line counters: the line policy's counters launch (simple_walk
     kind='line', thread i on ray i, near-first for closest-hit) on the
     line soup's bounce and shadow rays of 3b (launch counts asserted):
     kernel pops a ray beside the plain skip-link walk's nodes and leaves,
     hits against plain, timed beside the persistent launch;
  4. main path: render.render of testing.cornell_scene at 1024x576, mf=4,
     max_verts=6, NEE on, 4 spp, through the kernel (launch counts
     checked), plus the same path on the card against the CPU at 64x36;
  5. larger BVH: the plane scene rendered the same way at 2 spp;
  6. counters: want_counters through the union kernel (the TPU kernel's
     walk of each 128-ray tile) on the cornell, plane and soup BVHs at
     589,824 rays, bounce rays closest-hit and shadow segments any-hit:
     6 'counters' launches on its path, each held to the plain union walk
     (every block's counts, hits as phase 3, the share of rays equal in
     every bit printed) and launched twice (bit-identical); union pops a
     tile, per-ray pops a ray (simple_walk: 6 'tri_counters' launches,
     each ray's pops held to the plain per-ray walk's) and the lane share
     (per-ray pops over union pops times the tile's live lanes); the
     union, per-ray and persistent walks timed in turns, the union
     kernel's bound from its pops on live lanes;
  7. golden gates: scene.load_scene of data/golden/scenes/0031_hete and
     0030_subsurf on the card, rendered at the JAX gates' settings
     (tests/test_golden.py:134-173) and held to their RMSE and mean bounds;
  8. media path at full width: both scenes at 1024x576, mf=4, max_verts=8,
     NEE and media on, 2 spp through render.render (launch counts checked),
     and 0031 again with equiangular=True;
  8b. 0002_mb (a cube moving over the shutter: the moving-triangle form):
     the golden gate at the JAX test's settings (tests/test_golden.py:
     243-253), a 1024x576 frame, and its paths on the card against the
     CPU; a hair frame at 1024x576 (65,536 HAIR fibres over a diffuse
     ground under a constant sky and an area light, made from a seed: the
     line BVH form), and its paths on the card against the CPU, held to
     the bar on the frame's thick fibres and printed without a bar on
     fibres as thin as real hair;
  8c. the line and moving forms at their frames' own shapes: every launch
     of one hair and one 0002_mb progression captured from the frame's
     own calls (frame_calls) and launched again on the same tensors
     (frame_forms): each held against its plain version, two launches
     bit-identical, by the hold of 16 and 17 (_hold_launch; the moving
     form bit-equal on every ray, as in 3b), timed (a
     fresh carry each launch) and bound from the plain walk's visits on the
     same rays (the line form also with its early exit at the
     discriminant); launches, ms, bound and share a frame, the moving form
     beside the static walk of the same tree on the same rays (its
     yardstick) with its record bytes a leaf pop, before and now; the line
     counters on the hair frame's first bounce and shadow rays; the moving
     form on 65,536 rays aimed at edges that two leaves of the 0002_mb
     plane share (edge_rays), every bit equal to the plain walk's; one
     hair progression under torch.profiler (device ms a form);
  8e. the zoom frame (_zoom_scene: a 65,536-triangle log-spiral ribbon
     at the origin, a ground and a light; its tree too deep for the wide
     stack): the tree's wdepth, wide stack need and binary levels, a
     1024x576 render with 5 deep_closest and 5 deep_any launches a frame
     and nothing else, frame s (min / median / max) and Mrays/s; every
     deep launch of one progression held bit for bit and timed at the
     frame's shapes (frame_forms), the skip form (the same tree over the
     deep stack's limit) on the same launches beside it; both forms bit
     for bit on rays aimed at edges two of the tree's leaves share; one
     progression under torch.profiler; the paths on the card against the
     CPU at 64x36, bar 0.99;
  9. media path on the card against the CPU: sample_paths of 0031_hete at
     64x40;
 10. the CLI: python -m corona13_tpu_torch on 0031_hete, 256x160, 2 spp;
 11. sky: the plane scene under a 1024x2048 gradient sky with a sun disk
     (EnvMap.build timed with its fit on the card): a 1024x576 frame with
     envmap NEE (5 closest-hit and 10 any-hit launches), its peak memory
     (no [N, W] gather of CDF rows), one torch.profiler pass, the paths on
     the card against the CPU at 64x36 on the same tables, envmap.sample
     against envmap.pdf by the estimator of tests/test_envmap.py; the same
     scene under daylight.build((0.3, 0.2, 0.9), 2.5);
 12. compact: the plane scene with capacities from pt.alive_profile: with
     capacities 1.0 and with a 1.25 margin over the profile the image
     equals the dense one; with half the profile the energy holds within
     5% over 4 progressions; closest-hit and any-hit are launched at the
     capacities' ray counts and a progression, dense or compacted, makes no
     synchronizing call; dense and compacted frames timed in turns;
 13. grad: cornell at 1024x576: backward() of the frame mean for e_mul and
     d_mul against central differences (2e-3), its seconds and peak
     memory; the nonlinear parameters of tests/test_grad.py finite, ior_nd
     non-zero; gradients on the card against the CPU at 64x36;
 14. --dbor and --sampler vis through the CLI on 0002_mb; the cascade
     itself on the sky frame of 11, whose luminance spans the levels: at
     least two levels above 0 filled, their sum against the plain splat
     (1e-4), the card's levels and merge against the CPU's on the same
     samples (1e-5);
 15. light paths: lt, bdpt, ptlt and bdpt1 on cornell at 1024x576, mf=4,
     max_verts=6: 2 warm-up and 3 timed progressions each (min, median,
     max s/frame; closest-hit and any-hit launches a progression held to
     LIGHT_CALLS; rays; peak memory), one profiled bdpt progression, one
     bdpt frame of the plane scene; the four camera splats of a bdpt frame
     twice (bit-identical), against the CPU (1e-6), and the splat timed
     beside the index_add scatter it replaced; lt, bdpt, ptlt on the card
     against the CPU at 64x36 (1e-4 of the largest pixel on >= 99% of
     pixels) and bdpt1's picks and table over 4 progressions; the CLI
     with each of the four samplers on 0002_mb at 256x160;
 16. ppm, kmlt and vmlt on cornell at 1024x576, mf=4, max_verts=6, with
     the reference defaults (2 * W * H photon paths; 8192 chains, 8
     burn-in steps): s a frame (ppm 2 warm-up and 3 timed, the chains 1
     and 2), closest-hit and any-hit launches a frame held to _mlt_calls,
     peak memory, one profiled frame each (launches, busy share), 0
     synchronizing calls in one kmlt and one vmlt mutation step; the
     traversal forms at these samplers' shapes, captured from their own
     calls (a photon bounce of 1,179,648 rays; a replay bounce and its NEE
     shadow rays at 8192 chains), each against its plain version on the
     same tensors as 3b holds them; the three on the card against the CPU
     at 64x36 (chains=256);
 17. sharded: an NCCL process group of world size 1 (one H100) through a
     file:// store; parallel.shard.render_samples_sharded on cornell at
     1024x576, mf=4, max_verts=6, NEE on, 2 warm-up and 3 timed calls
     beside pt.render_sample of the same size (min / median / max s, the
     overhead share 1 - t_single / t_sharded, launches held to 5 of each
     form a frame, peak memory, one profiled call each), the sharded
     images against pt.render_sample off the pixels its pixel-aligned
     splat moves (_carried; rtol 2e-4, atol 1e-5: tests/test_parallel.py:
     28-29) and, a check of the collective alone, against the shard
     function over the whole film; meshes (2, 2) and (1, 4) emulated rank
     after rank on the card against the same two at the same tolerance
     (the second a check of the split alone); the traversal forms at a
     shard's shapes (294,912 and 147,456 rays) against their plain
     versions as in 16; parallel.dryrun.dryrun_multichip(1): its losses
     (the last below the first), seconds a step and peak memory.
The line before the last is a JSON record of the kernels, each with its
bound on this card: the larger of its bytes (inputs once, outputs once,
dead lanes only their t_init) over 3.35 TB/s and its float operations (the
pops this run's rays needed, on occupied children and rows; for the forms
of 3b the box and leaf tests of the plain skip-link walk on the same rays)
over 67 TFLOP/s.  The line and moving forms' rows give 3b's launch at the
soup's shapes as ms, bound and plain, and their frame's (8c) as frame_*:
the frame's sums and a launch's mean.  The line rows, the dense line list's
too, add exit_*, the bound with rows that miss at the discriminant counted
up to it (the kernel leaves them there), beside the bound above, which
counts the full test.  The moving rows add frame_static_*, the static walk
of the same tree on the same rays, and the edge rays on which the kernel
differs from the plain walk (0).  The deep and skip rows give their frame
numbers at the zoom frame's launches (8e) and the plane's and the zoom
tree's edge rays that differ (0).  The counters row is the union walk of
phase 6 on the plane's bounce rays (its ``definition`` key says so: rows
of that name from before timed the per-ray walk), with its lane share
and the share of rays equal in every bit to its plain version; the
per-ray counters row is the per-ray walk (simple_walk).  The last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import re
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
    print(f'built corona13_tpu_torch/csrc/traverse_tris.cu for sm_90a with '
          f'nvcc in {time.time() - t0:.1f} s', flush=True)
    report = ptxas_report(trace_cuda.build_log)
    for name, lines in report.items():
        for line in lines:
            print(f'  {name}: {line}', flush=True)
    print(f'{len(report)} kernel instantiations', flush=True)


def ptxas_report(build_log):
    """ptxas -v's lines of each instantiation (registers, stack frame and
    spills), keyed by kernel, leaf policy, then the template flags:
    any-hit, and for the wide walk counters and persistent."""
    out, name = {}, None
    for line in build_log.splitlines():
        if 'Compiling entry function' in line and 'union_kernel' in line:
            m = re.search(r'union_kernelILb([01])E', line)
            check(m is not None, f'unexpected kernel name: {line}')
            name = ('union Triangle '
                    + ('any-hit' if m.group(1) == '1' else 'closest-hit'))
            out[name] = []
        elif 'Compiling entry function' in line:
            m = re.search(r'\d+(traverse|deep|skip|dense)_kernelINS_\d+(\w+?)'
                          r'LeafE((?:Lb[01]E)+)', line)
            check(m is not None, f'unexpected kernel name: {line}')
            flags = re.findall(r'Lb([01])E', m.group(3))
            name = f'{m.group(1)} {m.group(2)} ' + \
                ('any-hit' if flags[0] == '1' else 'closest-hit')
            if m.group(1) == 'traverse':
                name += (' counters' if flags[1] == '1' else '') + \
                    (' persistent' if flags[2] == '1' else ' simple')
            out[name] = []
        elif name and ('registers' in line or 'stack frame' in line):
            out[name].append(line.split(':', 1)[-1].strip())
    return out


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


def _time_ms(fn, n_sets, reps, host=False, before=None):
    """Mean card ms per call over reps calls cycling over n_sets input
    sets, between CUDA events, ending in a synchronize and a read-back.
    ``before()``, where given, runs ahead of each pass (and of the spin):
    it makes the inputs that the calls update in place afresh.
    A dry pass measures how long the host takes to enqueue the calls; a
    spin kernel half as long again (at an SM clock of at most 2 GHz) then
    goes first, so that the host has enqueued every call before the card
    starts on them: the events bracket the card's time, not the host's
    pace of launching.  If the spin has ended by the time the host is done
    the pass is host-bound and is taken again behind twice the spin (at
    most three passes).  host=True also returns the host's microseconds
    per call to enqueue and whether the last pass was still host-bound."""
    if before is not None:
        before()
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i % n_sets)
    spin_s = (time.perf_counter() - t0) * 1.5 + 1e-3
    for _ in range(3):
        if before is not None:
            before()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))
        start.record()
        last = None
        t0 = time.perf_counter()
        for i in range(reps):
            last = fn(i % n_sets)
        host_us = (time.perf_counter() - t0) / reps * 1e6
        host_bound = start.query()    # the spin is over: the card was waiting
        end.record()
        torch.cuda.synchronize()
        if not host_bound:
            break
        spin_s *= 2
    float(last[0].float().sum().item())
    ms = start.elapsed_time(end) / reps
    if host_bound and not host:
        print(f'  (host-bound timing: {ms:.3f} ms a call is the host\'s '
              f'pace, {host_us:.0f} us to enqueue one)', flush=True)
    return (ms, host_us, host_bound) if host else ms


MAX_DIST = 3.4e38
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
# Float operations, counted from csrc/traverse_tris.cu, min/max and float
# compares each as one.  An inner pop tests a child with 6 subtractions, 6
# multiplications, 12 min/max and 4 compares; a leaf pop tests a row with 54
# (two cross products, four dot products, a divide, three scalings, the
# float compares); a live ray takes 3 clamped inverses (abs, compare,
# select, divide).  The kernel does the arithmetic of all 8 slots of a
# record; the bound counts only the occupied ones, which the walk needs.
OPS_CHILD, OPS_ROW, OPS_RAY = 28, 54, 12


def _bound_ms(b, n, alive, t_is_tensor, n_ignore, out_bytes, inner, leaf):
    """The least time the card could take: (ms, 'bytes' or 'operations').
    Bytes: the kernel's BVH records once, 24 B of origin and direction
    plus 8 B per ignore id for a live ray, t_init where it is a tensor and
    the outputs for every ray.  Operations: those of the pops this run's
    rays made (inner, leaf: totals from the counters launch) on occupied
    children and rows, at the tree's mean fill of a node and of a leaf (the
    counters do not say which records were popped)."""
    child_fill = float((b.knodes[:, :, 6] != 0).float().mean())
    row_fill = float((b.kleaves[:, :, 3].contiguous().view(torch.int32)
                      >= 0).float().mean())
    nbytes = ((b.knodes.numel() + b.kleaves.numel()) * 4
              + alive * (24 + 8 * n_ignore) + n * (4 * t_is_tensor + out_bytes))
    ops = (alive * OPS_RAY + inner * 8 * child_fill * OPS_CHILD
           + leaf * 8 * row_fill * OPS_ROW)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


# union_kernel's outputs: t, u, v (4 B each), prim, slot (8 B each) a ray,
# and the two counts of a 1024-ray block
UNION_OUT_BYTES = 28 + 8 / 1024


def union_lanes(b, n, alive, t_is_tensor, tile_stats, inner_r, leaf_r,
                scale=1.0):
    """The union walk's lane share and bound: (lane_share, bound_ms,
    bound_by).  tile_stats: union_walk_plain's per-tile pops, live lanes
    and open-lane sums; inner_r, leaf_r: the per-ray walk's pops on the
    same rays.  Lane share: the per-ray pops over the union's pops times
    its tile's live lanes, the share of a packet's lanes that a pop keeps
    busy.  Bound: _bound_ms over the union pops' tests on the lanes open
    at each pop (live and, under any-hit, not yet blocked), the work the
    outputs need; the pops scaled by `scale` (from a window of the rays to
    n, whose live rays `alive` counts)."""
    t_iters, t_leafs, live, inner_open, leaf_open = (
        torch.as_tensor(x).to(torch.int64) for x in tile_stats)
    lane_pops = int(((t_iters + t_leafs) * live).sum())
    lane_share = (inner_r + leaf_r) / max(lane_pops, 1)
    bound, by = _bound_ms(b, n, alive, t_is_tensor, 1, UNION_OUT_BYTES,
                          int(inner_open.sum()) * scale,
                          int(leaf_open.sum()) * scale)
    return lane_share, bound, by


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _plain_timed(case, **kw):
    """One call of the plain walk on the case's first input set: its
    outputs as numpy and its ms between CUDA events."""
    from corona13_tpu_torch.ops import trace_cuda
    b, any_hit, argsets = case
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                         *argsets[0], any_hit=any_hit, **kw)
    end.record()
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in out], start.elapsed_time(end)


def _run_case(name, case):
    """Kernel against plain on one case: two launches bit-identical, hits
    held to the plain walk's, the kernel timed over 20 launches."""
    from corona13_tpu_torch.ops import trace_cuda
    b, any_hit, argsets = case
    kern = lambda s: trace_cuda.traverse_tris(b, *argsets[s], any_hit=any_hit)
    first, second = kern(0), kern(0)
    torch.cuda.synchronize()
    check(all(torch.equal(_bits(x), _bits(y)) for x, y in zip(first, second)),
          f'{name}: two launches on the same inputs differ')
    k = [x.cpu().numpy() for x in first]
    p, plain_ms = _plain_timed(case)
    agree, err = _compare_hits(k, p, any_hit, name)
    res = dict(ms=_time_ms(kern, 2, 20), plain_ms=plain_ms, agree=agree,
               max_abs_err=err, hit_share=float((k[1] >= 0).mean()),
               alive=int(sum((a[2] > 0).sum() if torch.is_tensor(a[2])
                             else N_RAYS for a in argsets) // len(argsets)))
    if any_hit:
        # the form trace.occluded launches: only the blocked flag is written
        flag = lambda s: (trace_cuda.occluded_tris(b, *argsets[s]),)
        blocked, again = flag(0)[0], flag(0)[0]
        check(torch.equal(blocked, again) and
              torch.equal(blocked, first[1] >= 0),
              f'{name}: occluded_tris differs from traverse_tris')
        res['flag_ms'] = _time_ms(flag, 2, 20)
    slot_agree = agree if any_hit else float((k[4] == p[4]).mean())
    print(f'  {name:36s} {"any" if any_hit else "closest"}-hit: alive '
          f'{res["alive"] / N_RAYS:.4f}, hit share {res["hit_share"]:.4f}, '
          f'prim agree {agree:.6f}, slot agree {slot_agree:.6f}, max |dt| '
          f'{err:.3g}, two launches identical; kernel {res["ms"]:.3f} ms'
          + (f' ({res["flag_ms"]:.3f} ms writing only the flag)'
             if any_hit else '') + f', plain {plain_ms:.1f} ms', flush=True)
    return res


def main_bvhs(dev, cornell=None):
    """Phase 3's trees, each with two ray sets (_ray_sets, _soup_sets):
    the main path's cornell box (``cornell``, else built here), the plane
    scene and the 2^17-triangle soup; and the plane scene fitted to the
    film."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.ops import trace as trace_mod
    if cornell is None:
        cornell = testing.cornell_scene(device=dev)
    cornell = scene_mod.fit_film(cornell, W, H)
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    t0 = time.time()
    soup = trace_mod.make_device_geometry(tri_v=_soup(1 << 17, 7), device=dev)
    print(f'soup BVH (131072 triangles) built in {time.time() - t0:.1f} s',
          flush=True)
    return {'cornell': (cornell.geom,
                        _ray_sets(cornell.geom, cornell, dev, 1),
                        _ray_sets(cornell.geom, cornell, dev, 2)),
            'plane': (plane.geom, _ray_sets(plane.geom, plane, dev, 3),
                      _ray_sets(plane.geom, plane, dev, 4)),
            'soup': (soup, _soup_sets(dev, 5), _soup_sets(dev, 6))}, plane


def main_cases(bvhs, dev):
    """Phase 3's cases, 'tree/kind' -> (BVH, any-hit, two argument sets
    of traverse_tris as the main path passes them), kinds camera, bounce
    and shadow (any-hit)."""
    cases = {}
    for bname, (geom, set_a, set_b) in bvhs.items():
        b = geom.tri_bvh
        print(f'{bname}: {geom.n_tris} triangles, {b.wbounds.shape[0]} wide '
              f'nodes, {b.leaf_packed.shape[0]} leaves, stack depth '
              f'{b.stack_depth} ({b.stack_depth * 512} B of shared memory a '
              f'block)', flush=True)
        for kind in ('camera', 'bounce', 'shadow'):
            argsets = []
            for rays in (set_a, set_b):        # two input sets, varied
                o, d, ig, *tm = rays[kind]
                # as the main path passes them: int64 ids and a tensor of
                # segment ends (MAX_DIST on a live bounce ray); the camera
                # rays take the one-float form of an unbounded ray
                t = tm[0].contiguous() if tm else MAX_DIST if kind == 'camera' \
                    else torch.full((N_RAYS,), MAX_DIST, device=dev)
                argsets.append((o.contiguous(), d.contiguous(), t,
                                ig.contiguous()))
            cases[f'{bname}/{kind}'] = (b, kind == 'shadow', argsets)
    return cases


def kernel_phase(dev, card):
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'kernel against plain, {N_RAYS} rays per call, on {card}')
    # an entry point without a device argument: it builds on the card
    cornell = testing.cornell_scene()
    check(cornell.device.type == 'cuda', f'cornell_scene() built on '
          f'{cornell.device}, not on the card')
    bvhs, plane = main_bvhs(dev, cornell)
    cases = main_cases(bvhs, dev)
    # the main path's alive shares: bounces 2 and 4 of the plane scene
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    prof = pt_mod.alive_profile(plane, cfg, 0).cpu().numpy() / N_RAYS
    print(f'plane scene alive shares per bounce: '
          f'{", ".join(f"{x:.4f}" for x in prof)}', flush=True)
    g = torch.Generator(device='cpu').manual_seed(9)
    for tag, share in ((f'bounce 2 alive {prof[2]:.4f}', float(prof[2])),
                       (f'bounce 4 alive {prof[4]:.4f}', float(prof[4])),
                       ('all dead', 0.0)):
        for bname in ('plane', 'soup'):
            for kind in ('bounce', 'shadow'):
                if tag == 'all dead' and (bname, kind) != ('plane', 'bounce'):
                    continue
                b, any_hit, argsets = cases[f'{bname}/{kind}']
                dead = []
                for o, d, t, ig in argsets:
                    live = (torch.rand(N_RAYS, generator=g) < share).to(dev)
                    dead.append((o, d, torch.where(live, t, 0.0), ig))
                cases[f'{bname}/{kind}/{tag}'] = (b, any_hit, dead)
    results = {'closest': {}, 'any': {}}
    for name, case in cases.items():
        results['any' if case[1] else 'closest'][name] = _run_case(name, case)
    dead = results['closest']['plane/bounce/all dead']
    check(dead['hit_share'] == 0.0 and dead['alive'] == 0,
          'the all-dead case traced something')
    print('tolerance: prim and slot (any-hit: blocked) identical on >= 99.9% '
          'of rays, t within rtol 1e-6 where prim agrees; two launches of a '
          'case bit-identical', flush=True)
    return results, bvhs, cases


def _cuda_launches(fn):
    """Names of the CUDA kernels, copies and memsets that one call of fn
    puts on the card, from torch.profiler.  A trace that holds no device
    event at all has lost the call's (every caller here launches at least
    one kernel; the tracer has dropped them once on an H100): it is taken
    again, at most three times, and the last is returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for i in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        print(f'  (trace {i + 1} of one call holds no device event; taken '
              f'again)', flush=True)
    return names


def callers_phase(bvhs, kres, card):
    """trace.intersect and trace.occluded as the sampler calls them: ms
    per call with the wrapper, beside the bare triangle kernel, and the
    CUDA launches of one call: one kernel per prim kind (cornell: the
    triangle walk and the dense sphere list) and no torch launch."""
    from corona13_tpu_torch.ops import trace as trace_mod
    phase(f'intersect / occluded as callers see them, {N_RAYS} rays, on '
          f'{card}')
    out = {}
    for bname in ('cornell', 'plane'):
        geom, set_a, set_b = bvhs[bname]
        sets = [(s['bounce'], s['shadow']) for s in (set_a, set_b)]
        isect = lambda i: (trace_mod.intersect(
            geom, sets[i][0][0], sets[i][0][1], ignore_prim=sets[i][0][2]).t,)
        occl = lambda i: (trace_mod.occluded(
            geom, sets[i][1][0], sets[i][1][1], sets[i][1][3],
            ignore_prim=sets[i][1][2], ignore_prim2=sets[i][1][2]),)
        for call, fn, key, kind, field in (
                ('intersect', isect, 'closest', 'bounce', 'ms'),
                ('occluded', occl, 'any', 'shadow', 'flag_ms')):
            names = _cuda_launches(lambda: fn(0))
            is_ours = lambda n: any(k in n for k in (
                'traverse_kernel', 'skip_kernel', 'dense_kernel'))
            ours = [n for n in names if is_ours(n)]
            others = [n for n in names if not is_ours(n)]
            ms, host_us, host_bound = _time_ms(fn, 2, 20, host=True)
            bare = kres[key][f'{bname}/{kind}'][field]
            whose = "at the host's pace" if host_bound else 'of the card'
            print(f'  {bname} {call}: {ms:.3f} ms {whose} per call (the '
                  f'host takes {host_us:.0f} us to enqueue one), bare '
                  f'triangle kernel {bare:.3f} ms; CUDA launches in one call: '
                  f'{len(ours)} kernel + {len(others)} torch '
                  f'({", ".join(sorted(set(n[:40] for n in others)))})',
                  flush=True)
            kinds = 1 + (geom.n_spheres > 0) + (geom.n_lines > 0)
            check(len(ours) == kinds, f'{bname} {call}: {len(ours)} kernel '
                  f'launches in one call, {kinds} prim kinds')
            check(len(others) == 0, f'{bname} {call}: {len(others)} torch '
                  f'launches around the kernels: {others}')
            out[f'{bname}/{call}'] = dict(ms=ms, host_us=host_us,
                                          host_bound=host_bound,
                                          kernel_ms=bare,
                                          torch_launches=len(others))
    return out


# --- phase 3b: the forms that replace XLA's _traverse ------------------------

# Float operations of one leaf row for one ray, counted from
# csrc/traverse_tris.cu as OPS_ROW is: a lerped triangle row adds 27 for the
# nine lerps and 1 for 1 - w to the triangle's 54 (the ray's time enters, so
# none of it is the prim's alone); a sphere takes 25 (3 subtractions, two
# dot products, the subtraction of r*r, the discriminant, max and sqrt, two
# roots, the compares); a cone 75 (3 subtractions, four dot products, s, the
# quadratic's a, b, c and discriminant, max and sqrt, the sign, q, two
# roots, min/max, two acceptance tests, the axial fraction).  OPS_PRIM_OF:
# what a test computes from the prim alone, which the least work does once a
# prim and not once a ray: r*r of a sphere; a cone's axis, its length, the
# three divisions and the slope k, 15.  A node of the skip-link walk is one
# box test, OPS_CHILD.  OPS_LINE_DISC: the cone test up to and with its
# discriminant's compare (3 subtractions, four dot products, s, a, b, c, the
# discriminant), where the line form's kernel leaves a row that misses.
OPS_ROW_OF = {'tri': OPS_ROW, 'moving': OPS_ROW + 28, 'sphere': 25, 'line': 75}
OPS_PRIM_OF = {'tri': 0, 'moving': 0, 'sphere': 1, 'line': 15}
OPS_LINE_DISC = 45
# The forms _form_compare holds bit for bit on every ray: the wide walk of
# each prim kind named here, which walks in the reference's order, and the
# walks of a tree without a wide layout, which take the skip-link walk's
# order: 'deep' (a stack) and 'skip' (skip links, for a tree too deep for
# that stack) (scripts/trace_times.py empties it to time an older
# checkout).
EXACT_KINDS = ('moving', 'sphere', 'deep', 'skip')


def _exact(form, kind):
    """Whether a form of a kind is held bit for bit (EXACT_KINDS)."""
    return (form in ('deep', 'skip') and form in EXACT_KINDS) or (
        form == 'wide' and kind in EXACT_KINDS)


def _deep_tree(bvh):
    """``bvh`` without its wide layout, as upload lays out a tree too deep
    for the wide stack (trace.without_wide; a checkout from before it,
    timed by scripts/trace_times.py --root, drops the wide fields)."""
    import dataclasses
    from corona13_tpu_torch.ops import trace as trace_mod
    if hasattr(trace_mod, 'without_wide'):
        return trace_mod.without_wide(bvh)
    return dataclasses.replace(bvh, wbounds=None, wlinks=None,
                               leaf_packed=None, knodes=None, stack_depth=0)


def _skip_tree(bvh):
    """``bvh`` as upload lays out a tree with more binary levels than
    trace_cuda.MAX_BIN_STACK (the skip form): no wide layout and no deep
    records."""
    import dataclasses
    return dataclasses.replace(_deep_tree(bvh), bnodes=None, bin_depth=0)


def moving_soup(dev):
    """Phase 3b's moving soup: 2^17 random triangles (_soup), each moved by
    up to one unit on every axis over the shutter, so that every row
    moves."""
    from corona13_tpu_torch.ops import trace as trace_mod
    tri = _soup(1 << 17, 7)
    g = np.random.default_rng(8)
    return trace_mod.make_device_geometry(
        tri_v=tri, tri_v_t1=tri + g.uniform(
            -1, 1, (len(tri), 1, 3)).astype(np.float32), device=dev)


def _sphere_soup(n, seed):
    g = np.random.default_rng(seed)
    return dict(sph_c=g.uniform(-50, 50, (n, 3)).astype(np.float32),
                sph_r=g.uniform(0.2, 1.2, n).astype(np.float32))


def _line_soup(n, seed, box=50.0, length=2.0, radius=0.2):
    g = np.random.default_rng(seed)
    a = g.uniform(-box, box, (n, 3)).astype(np.float32)
    b = a + g.uniform(-length, length, (n, 3)).astype(np.float32)
    return dict(line_vtx=np.stack([a, b], axis=1),
                line_radii=g.uniform(0.1 * radius, radius,
                                     (n, 2)).astype(np.float32))


def _form_bound(target, kind, form, n, alive, out_bytes, visits, leafs,
                missed=0):
    """The least time the card could take for one fresh launch of a form:
    (ms, 'bytes' or 'operations').  Bytes: the records the form reads once
    (a tree's nodes and leaf rows, and the sphere form's ids where its rows
    leave them out; a dense list's arrays), 24 B of origin
    and direction and 8 B of ignore id for a live ray, 4 B of ray time for
    a live ray of a form that lerps (moving triangles, a dense sphere list
    with shutter-close centres; the others are given no time), t_init and
    ``out_bytes`` of outputs for every ray.  Operations: 12 a live ray; what
    a test computes from the prim alone once a prim; a tree: one box test a
    node visited and the leaf rows tested, as the plain skip-link walk
    counted them on these rays, at the tree's mean row fill; a dense list:
    every live ray against every prim.  ``missed`` (0: the definition
    above): line rows the plain walk or the plain dense list found with a
    discriminant that is not positive, counted at OPS_LINE_DISC, where the
    kernel leaves them, and not at the full test."""
    if form == 'dense':
        recs = sum(x.numel() for x in target if x is not None) * 4
        n_prims = target[0].shape[0]
        lerps = kind == 'sphere' and target[2] is not None
        ops = (alive * (OPS_RAY + n_prims * (OPS_ROW_OF[kind] + 10 * lerps))
               + n_prims * OPS_PRIM_OF[kind]
               - missed * (OPS_ROW_OF[kind] - OPS_LINE_DISC))
    else:
        nodes = target.knodes if form == 'wide' else target.nodes
        lerps = kind == 'moving'
        rows = [nodes, target.kleaves] + ([target.kleaves_t1] if lerps else [])
        if kind == 'sphere' and target.kleaves.shape[-1] == 4:
            rows.append(target.leaf_prims)   # 16 B rows: the ids apart
        recs = sum(r.numel() * r.element_size() for r in rows)
        filled = target.leaf_prims >= 0
        ops = (alive * OPS_RAY + visits * OPS_CHILD
               + leafs * 8 * float(filled.float().mean()) * OPS_ROW_OF[kind]
               + int(filled.sum()) * OPS_PRIM_OF[kind]
               - missed * (OPS_ROW_OF[kind] - OPS_LINE_DISC))
    nbytes = recs + alive * (24 + 8 + 4 * lerps) + n * (4 + out_bytes)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


def _plain_counts(form, kind, plain, *args, **kw):
    """A form's plain version and, for a tree the skip-link walk serves,
    its per-ray counts: (hit, nodes visited, leaves tested, line rows
    missed at the discriminant); a dense line list gives (hit, 0, 0, lines
    missed at the discriminant), a dense sphere list and the static wide
    triangles (hit, 0, 0, None).  The last is None where the package's
    plain versions do not count such rows (scripts/trace_times.py --root
    imports another checkout's)."""
    if (form == 'dense' and kind != 'line') or (form, kind) == ('wide', 'tri'):
        return plain(*args, **kw), 0, 0, None
    hit, *counts = plain(*args, want_counts=True, **kw)
    if not counts:     # a checkout whose dense list counts nothing
        return hit, 0, 0, None
    visits, leafs, *missed = counts
    return hit, visits, leafs, missed[0] if missed else None


def _total(count):
    """A per-ray count summed over the rays (a number or None as given)."""
    return int(count.sum()) if torch.is_tensor(count) else count


def _form_compare(k, p, any_hit, where, exact=False):
    """A form's kernel against its plain version: the shares of rays that
    agree on prim, on slot and (any-hit) on blocked, and max |dt| where
    prim agrees.  Threshold: >= 99.9% on each, t within rtol 1e-6; the
    aim is 1.000000 and max |dt| 0, as the triangle cases have.  exact
    (the moving form, which walks in the reference's order): t, prim, u,
    v, slot and blocked equal bit for bit on every ray."""
    if exact:
        pairs = zip((k,), (p,)) if any_hit else zip(k, p)
        differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in pairs)
        check(differ == 0, f'{where}: {differ} outputs differ from the '
              f'plain walk in a bit')
    if any_hit:
        agree = float((k == p).float().mean())
        check(agree >= 0.999, f'{where}: blocked agrees on only {agree}')
        return agree, agree, 0.0
    agree = float((k[1] == p[1]).float().mean())
    slot = float((k[4] == p[4]).float().mean())
    same = (k[1] == p[1]) & (k[1] >= 0)
    dt = (k[0][same] - p[0][same]).abs()
    err = float(dt.max()) if dt.numel() else 0.0
    rel = float((dt / p[0][same].abs().clamp(min=1e-30)).max()) \
        if dt.numel() else 0.0
    uv = float(max((k[2][same] - p[2][same]).abs().max(),
                   (k[3][same] - p[3][same]).abs().max())) if dt.numel() \
        else 0.0
    check(agree >= 0.999 and slot >= 0.999,
          f'{where}: kernel and plain agree on only {agree} / {slot}')
    check(rel <= 1e-6 and uv <= 1e-6, f'{where}: t rel err {rel}, uv {uv}')
    return agree, slot, err


def _run_form(name, target, kind, offset, any_hit, argsets):
    """One form against its plain version on one case.  argsets: two input
    sets (org, dir, t_init with dead lanes, ignore ids, and ray times or
    None, as trace.intersect hands the form its rays).  First
    a fresh launch (timed over 20 launches), then a launch that carries a
    running hit in (closest-hit: a random closer t on half the lanes with
    marker values in prim, u, v, slot; any-hit: a fifth of the lanes
    blocked already); each launched twice and held bit-identical."""
    from corona13_tpu_torch.ops import trace_cuda
    form = trace_cuda._form_of(target, kind)
    kw = [dict(time=a[4], prim_offset=offset) for a in argsets]
    if any_hit:
        kern = lambda s, carry=None: trace_cuda.any_hit(
            target, kind, *argsets[s][:4], argsets[s][3], carry=carry, **kw[s])
        plain = lambda carry=None, **c: trace_cuda.any_hit_plain(
            target, kind, *argsets[0][:4], argsets[0][3], carry=carry,
            **kw[0], **c)
        tup = lambda x: (x,)
    else:
        kern = lambda s, carry=None: trace_cuda.closest_hit(
            target, kind, *argsets[s][:4], carry=carry, **kw[s])
        plain = lambda carry=None, **c: trace_cuda.closest_hit_plain(
            target, kind, *argsets[0][:4], carry=carry, **kw[0], **c)
        tup = lambda x: x
    same_bits = lambda a, b: all(torch.equal(_bits(x), _bits(y))
                                 for x, y in zip(tup(a), tup(b)))
    first, second = kern(0), kern(0)
    torch.cuda.synchronize()
    check(same_bits(first, second), f'{name}: two launches differ')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p, *counts = _plain_counts(form, kind, plain)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    visits, leafs, missed = map(_total, counts)
    exact = _exact(form, kind)
    agree, slot, err = _form_compare(first, p, any_hit, name, exact)
    # the same rays with a running hit carried in
    n = argsets[0][0].shape[0]
    dev = argsets[0][0].device
    g = torch.Generator(device='cpu').manual_seed(11)
    if any_hit:
        run = (torch.rand(n, generator=g) < 0.2).to(dev)
        clone = lambda: run.clone()
    else:
        t0 = argsets[0][2]
        closer = (torch.rand(n, generator=g) < 0.5).to(dev)
        reach = 20.0 if form == 'dense' else 60.0
        t_run = torch.where(closer & (t0 > 0),
                            torch.rand(n, generator=g).to(dev) * reach, t0)
        run = (t_run, torch.full((n,), 7, dtype=torch.int64, device=dev),
               torch.full((n,), 0.25, device=dev),
               torch.full((n,), 0.5, device=dev),
               torch.full((n,), 3, dtype=torch.int64, device=dev))
        clone = lambda: tuple(x.clone() for x in run)
    c1, c2 = kern(0, clone()), kern(0, clone())
    torch.cuda.synchronize()
    check(same_bits(c1, c2), f'{name}: two carried launches differ')
    pc = plain(run)
    c_agree, c_slot, c_err = _form_compare(c1, pc, any_hit, name + ' carried',
                                           exact)
    if any_hit:
        check(bool((c1 | ~run).all()), f'{name}: a blocked lane came unset')
        improved = int((c1 & ~run).sum())
        hit_share = float(first.float().mean())
    else:
        improved = int((c1[0] != run[0]).sum())
        hit_share = float((first[1] >= 0).float().mean())
    alive = int((argsets[0][2] > 0).sum())
    ms = _time_ms(lambda s: tup(kern(s)), 2, 20)
    out_bytes = 1 if any_hit else 28
    bound, by = _form_bound(target, kind, form, n, alive, out_bytes, visits,
                            leafs)
    exit_bound = _form_bound(target, kind, form, n, alive, out_bytes, visits,
                             leafs, missed)[0] \
        if kind == 'line' and missed is not None else None
    print(f'  {name:30s} {"any" if any_hit else "closest"}-hit ({form}): '
          f'alive {alive / n:.4f}, hit share {hit_share:.4f}, prim agree '
          f'{agree:.6f}, slot agree {slot:.6f}, max |dt| {err:.3g}; carried: '
          f'agree {c_agree:.6f} / {c_slot:.6f}, max |dt| {c_err:.3g}, '
          f'{improved} rays improved; two launches identical; kernel '
          f'{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms by '
          f'{by} (share {bound / ms:.3f})'
          + (f'; skip-link walk {visits / n:.2f} nodes / {leafs / n:.2f} '
             f'leaves a ray' if form != 'dense' else '')
          + (f'; {missed / n:.2f} rows a ray missed at the discriminant, '
             f'bound with the early exit {exit_bound:.4f} ms (share '
             f'{exit_bound / ms:.3f})' if exit_bound is not None else ''),
          flush=True)
    rec = dict(ms=ms, plain_ms=plain_ms, agree=min(agree, c_agree),
               slot_agree=min(slot, c_slot), max_abs_err=max(err, c_err),
               hit_share=hit_share, alive=alive, bound_ms=bound, bound_by=by,
               form=form, nodes_per_ray=visits / n, leaves_per_ray=leafs / n)
    if exit_bound is not None:
        rec.update(exit_bound_ms=exit_bound, missed_rows_per_ray=missed / n)
    return rec


def forms_phase(dev, card, bvhs, only=None):
    """Phase 3b: see the module docstring.  Returns the per-case results
    keyed by the entry of trace_cuda.launches each case exercises, and the
    launch counts of the intersect / occluded calls that reach the forms no
    render reaches.  ``only``: the targets to run ('moving', 'dense_line',
    ...; scripts/trace_times.py), without the intersect / occluded calls
    (their launch counts are then None)."""
    import dataclasses
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'forms that replace _traverse against plain, {N_RAYS} rays per '
          f'call, on {card}')
    t0 = time.time()
    want = lambda *keys: only is None or any(k in only for k in keys)
    moving = spheres = lines = None
    if want('moving'):
        moving = moving_soup(dev)
    if want('sphere'):
        spheres = trace_mod.make_device_geometry(**_sphere_soup(1 << 16, 9),
                                                 device=dev)
    if want('line'):
        lines = trace_mod.make_device_geometry(**_line_soup(1 << 16, 10),
                                               device=dev)
    built = {k: g for k, g in (('moving soup (131072 triangles)', moving),
                               ('sphere soup (65536)', spheres),
                               ('line soup (65536)', lines)) if g is not None}
    bvh_of = lambda g: next(b for b in (g.tri_bvh, g.sph_bvh, g.line_bvh)
                            if b.knodes is not None and b.n_nodes > 1)
    print(f'{", ".join(built)} built in {time.time() - t0:.1f} s; wide nodes '
          + ' / '.join(str(bvh_of(g).knodes.shape[0]) for g in built.values())
          + ', stack depths '
          + ' / '.join(str(bvh_of(g).stack_depth) for g in built.values()),
          flush=True)
    soup, soup_a, soup_b = bvhs['soup']
    # the static soup's tree without its wide layout (the deep walk) and,
    # over the deep walk's stack limit, walked by skip links
    deep = _deep_tree(soup.tri_bvh) if want('deep', 'skip') else None
    skip = _skip_tree(soup.tri_bvh) if want('skip') else None
    cornell, corn_a, corn_b = bvhs['cornell']
    box = _line_soup(64, 12, box=4.0, length=3.0, radius=0.3)
    box['line_vtx'] = box['line_vtx'] + np.array([0, 0, 15], np.float32)
    few = trace_mod.make_device_geometry(**box, device=dev)
    dense_sph = (cornell.sph_c, cornell.sph_r, None)
    # the records packed at upload (a checkout from before them, timed by
    # scripts/trace_times.py --root, takes the lines' own arrays)
    dense_line = (few.line_dense,) if hasattr(few, 'line_dense') else \
        (few.line_v0, few.line_v1, few.line_r0, few.line_r1)
    targets = {
        'moving': (moving and moving.tri_bvh, 'moving', 0, (soup_a, soup_b)),
        'sphere': (spheres and spheres.sph_bvh, 'sphere', 1000,
                   (soup_a, soup_b)),
        'line': (lines and lines.line_bvh, 'line', 2000, (soup_a, soup_b)),
        'deep': (deep, 'tri', 0, (soup_a, soup_b)),
        'skip': (skip, 'tri', 0, (soup_a, soup_b)),
        'dense_sphere': (dense_sph, 'sphere', cornell.n_tris, (corn_a, corn_b)),
        'dense_line': (dense_line, 'line', 12, (corn_a, corn_b)),
    }
    targets = {k: v for k, v in targets.items() if want(k)}
    gen = torch.Generator(device='cpu').manual_seed(13)
    res, line_sets = {}, {}
    for key, (target, kind, offset, sets) in targets.items():
        for mode, ray_kind in (('closest', 'bounce'), ('any', 'shadow')):
            argsets = []
            if key == 'line':
                line_sets[mode] = (target, offset, argsets)
            for rays in sets:
                o, d, _, *seg = rays[ray_kind]
                t = seg[0] if seg else torch.full((N_RAYS,), MAX_DIST,
                                                  device=dev)
                live = (torch.rand(N_RAYS, generator=gen) < 0.9).to(dev)
                t = torch.where(live, t, 0.0).contiguous()
                # a ray time only where trace.intersect passes one on: to
                # the form that lerps
                tm = torch.rand(N_RAYS, generator=gen).to(dev) \
                    if kind == 'moving' else None
                o, d = o.contiguous(), d.contiguous()
                # a third of the lanes exclude the prim they would hit
                hit = trace_cuda.closest_hit(target, kind, o, d, MAX_DIST,
                                             time=tm, prim_offset=offset)
                ig = torch.where(torch.arange(N_RAYS, device=dev) % 3 == 0,
                                 hit[1], -1).contiguous()
                argsets.append((o, d, t, ig, tm))
            res[f'{key}_{mode}'] = _run_form(f'{key}/{ray_kind}', target, kind,
                                             offset, mode == 'any', argsets)
    print('tolerance: moving triangles: t, prim, u, v, slot and blocked '
          'bit-equal on every ray, fresh and carried; the other forms: prim, '
          'slot and blocked identical on >= 99.9% of rays, t within rtol '
          '1e-6 where prim agrees (the aim, 1.000000 and max |dt| 0, is '
          'printed per case); two launches of a case bit-identical',
          flush=True)
    if only is not None:
        return res, None, line_sets
    # the forms no render of this script reaches, through the entry points
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    tm = torch.rand(N_RAYS, generator=gen).to(dev)
    deep_geom = dataclasses.replace(soup, tri_bvh=deep)
    skip_geom = dataclasses.replace(soup, tri_bvh=skip)
    for geom in (spheres, few, deep_geom, skip_geom):
        rays = corn_a if geom is few else soup_a
        o, d, _ = rays['bounce']
        so, sd, _, seg = rays['shadow']
        h = trace_mod.intersect(geom, o, d, time=tm)
        b = trace_mod.occluded(geom, so, sd, seg, time=tm)
        check(bool(h.valid.any()) and bool(b.any()),
              'a form path found no hit')
    torch.cuda.synchronize()
    launches = {k: v for k, v in trace_cuda.launches.items() if v}
    print(f'intersect / occluded on the sphere soup, on 64 lines and on the '
          f'deep tree, by the deep walk and by skip links: launches '
          f'{launches}', flush=True)
    check(launches == {f'{k}_{m}': 1 for k in ('sphere', 'dense_line', 'deep',
                                               'skip')
                       for m in ('closest', 'any')},
          f'form path launch counts {launches}')
    return res, launches, line_sets


def line_counts(where, target, offset, mode, args, card, time_it=True):
    """The line policy's counters launch (simple_walk kind='line': thread
    i walks ray i, near-first for closest-hit, as the persistent launch
    walks it) on one set of rays (org, dir, t_init, ignore ids, the second
    ignore ids or None): inner and
    leaf pops a ray beside the plain skip-link walk's nodes and leaves on
    the same rays, its hits held to the plain walk's (_form_compare), and
    with time_it its ms beside the persistent launch's."""
    from corona13_tpu_torch.ops import trace_cuda
    any_hit = mode == 'any'
    o, d, t, ig, ig2 = args
    walk = lambda: trace_cuda.simple_walk(target, o, d, t, ig, ig2,
                                          any_hit=any_hit, kind='line',
                                          prim_offset=offset)
    out = walk()
    plain = trace_cuda.any_hit_plain if any_hit else \
        trace_cuda.closest_hit_plain
    kw = dict(ignore_prim2=ig2) if any_hit else {}
    p, visits, leafs, *_ = plain(target, 'line', o, d, t, ig,
                                 prim_offset=offset, want_counts=True, **kw)
    k = out[1] >= 0 if any_hit else out[:5]
    agree, slot, err = _form_compare(k, p, any_hit, f'{where} counters')
    n = o.shape[0]
    alive = int((t > 0).sum()) if torch.is_tensor(t) else n
    rec = dict(inner_per_ray=int(out[5].sum()) / n,
               leaf_per_ray=int(out[6].sum()) / n,
               plain_nodes_per_ray=int(visits.sum()) / n,
               plain_leaves_per_ray=int(leafs.sum()) / n, agree=agree,
               max_abs_err=err, alive=alive)
    if time_it:
        if any_hit:
            pers = lambda s: (trace_cuda.any_hit(target, 'line', o, d, t, ig,
                                                 ig2, prim_offset=offset),)
        else:
            pers = lambda s: trace_cuda.closest_hit(target, 'line', o, d, t,
                                                    ig, prim_offset=offset)
        rec['ms'] = _time_ms(lambda s: walk(), 1, 20)
        rec['ms_persistent'] = _time_ms(pers, 1, 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain(target, 'line', o, d, t, ig, prim_offset=offset,
              want_counts=True, **kw)
        end.record()
        torch.cuda.synchronize()
        rec['plain_ms'] = start.elapsed_time(end)
        rec['bound_ms'], rec['bound_by'] = _form_bound(
            target, 'line', 'wide', n, alive, 1 if any_hit else 28,
            int(visits.sum()), int(leafs.sum()))
    print(f'  {where:24s} line_{mode} counters: {n} rays, alive {alive}; '
          f'kernel pops a ray {rec["inner_per_ray"]:.2f} inner / '
          f'{rec["leaf_per_ray"]:.2f} leaf, plain skip-link walk '
          f'{rec["plain_nodes_per_ray"]:.2f} nodes / '
          f'{rec["plain_leaves_per_ray"]:.2f} leaves; '
          + (f'blocked agree {agree:.6f}' if any_hit else
             f'prim agree {agree:.6f}, max |dt| {err:.3g}')
          + (f'; counters launch {rec["ms"]:.4f} ms, persistent '
             f'{rec["ms_persistent"]:.4f} ms, plain {rec["plain_ms"]:.1f} ms'
             if time_it else '') + f' on {card}', flush=True)
    return rec


def line_counters_phase(line_sets, card):
    """Phase 3c: the line policy's counters launch on the line soup's
    bounce and shadow rays of 3b, with the launch counts zeroed just before
    and read just after (a debug path: no render launches it)."""
    phase(f'line counters: the ConeLeaf counters launch on the 2^16-line '
          f'soup, {N_RAYS} rays, on {card}')
    from corona13_tpu_torch.ops import trace_cuda
    _zero_launches()
    # as 3b launches them: any-hit excludes the same id twice
    rays = {m: argsets[0][:4] + (argsets[0][3] if m == 'any' else None,)
            for m, (_, _, argsets) in line_sets.items()}
    for m, (target, offset, _) in line_sets.items():
        trace_cuda.simple_walk(target, *rays[m], any_hit=m == 'any',
                               kind='line', prim_offset=offset)
    torch.cuda.synchronize()
    launches = _read_launches()
    print(f'line counters launches {launches}', flush=True)
    check(launches == {'line_counters': len(line_sets)},
          f'line counters launch counts {launches}')
    outs = {m: line_counts(f'soup {m}', target, offset, m, rays[m], card)
            for m, (target, offset, _) in line_sets.items()}
    return outs, launches


def edge_rays(geom, n, seed, dev):
    """Rays aimed at the edges that two triangles of different leaves of
    the triangle BVH share (a point along the edge, a quarter of them at
    its midpoint), from points above the scene along its thinnest axis:
    on a planar mesh each hits two triangles at once, often at the same t,
    where the walk's order and its box culls decide the winner.  Returns
    (org, dir, time, seg) on dev: ray times in [0, 1] with 0 and 1 among
    them, and shadow segments that end just short of or just past the
    edge."""
    b = geom.tri_bvh
    v0 = geom.tri_v0.cpu().numpy()
    tri = np.stack([v0, v0 + geom.tri_e1.cpu().numpy(),
                    v0 + geom.tri_e2.cpu().numpy()], axis=1)
    prims = b.leaf_prims.cpu().numpy()
    leaf_of = np.empty(len(tri), np.int64)
    leaf_of[prims[prims >= 0]] = np.nonzero(prims >= 0)[0] // 8
    first_leaf = {}
    shared = []
    for t in range(len(tri)):
        for i, j in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(tri[t, i]), tuple(tri[t, j]))))
            other = first_leaf.setdefault(key, leaf_of[t])
            if other != leaf_of[t]:
                shared.append(key)
    check(shared, 'edge_rays: no edge is shared across leaves')
    ends = np.asarray(shared, np.float32)                # [E, 2, 3]
    g = np.random.default_rng(seed)
    e = g.integers(0, len(ends), n)
    a = g.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    a[: n // 4] = 0.5
    aim = (ends[e, 0] * (1 - a) + ends[e, 1] * a).astype(np.float32)
    root = b.nodes[0].cpu().numpy()
    lo, hi = root[0:3], root[3:6]
    ext = hi - lo
    up = int(np.argmin(ext))
    org = ((lo + hi) / 2 + g.uniform(-0.6, 0.6, (n, 3)) * ext).astype(
        np.float32)
    org[:, up] = hi[up] + g.uniform(0.5, 5.0, n) * max(float(ext[up]), 1.0)
    d = aim - org
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    tm = g.uniform(0.0, 1.0, n).astype(np.float32)
    tm[::7], tm[1::7] = 0.0, 1.0
    seg = (dist * np.where(np.arange(n) % 2 == 0, 0.999, 1.001)).astype(
        np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (org, d, tm, seg))


def _near_pairs(c, cell):
    """(i, j) with i < j of the points c [n, 3] whose grid cells of size
    ``cell`` touch (the same cell or one of its 26 neighbours): every pair
    closer than ``cell``, among others."""
    q = np.floor((c - c.min(axis=0)) / cell).astype(np.int64) + 1
    span = q.max(axis=0) + 2
    key = lambda x: (x[:, 0] * span[1] + x[:, 1]) * span[2] + x[:, 2]
    order = np.argsort(key(q), kind='stable')
    sk = key(q)[order]
    out_i, out_j = [], []
    for off in np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing='ij'),
                        -1).reshape(-1, 3):
        nk = key(q + off)
        lo = np.searchsorted(sk, nk, 'left')
        cnt = np.searchsorted(sk, nk, 'right') - lo
        i = np.repeat(np.arange(len(c)), cnt)
        start = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
        j = order[start + np.arange(len(i))]
        keep = i < j
        out_i.append(i[keep])
        out_j.append(j[keep])
    return np.concatenate(out_i), np.concatenate(out_j)


def sphere_edge_rays(geom, n, seed, dev):
    """Rays aimed at points that two overlapping spheres of different
    leaves of the sphere BVH share: points on the circle where the two
    spheres meet, a quarter of them where that circle crosses the plane
    through both centres parallel to the y axis (x for a pair along y),
    each from a point outside both spheres at 1 to 20 mean radii, so that
    it meets both at nearly the same t, where the walk's order and its box
    culls decide the winner.  Returns (org, dir, seg) on dev, with shadow
    segments that end just short of or just past the point."""
    b = geom.sph_bvh
    c = geom.sph_c.cpu().numpy().astype(np.float64)
    r = geom.sph_r.cpu().numpy().astype(np.float64)
    prims = b.leaf_prims.cpu().numpy()
    leaf_of = np.empty(len(r), np.int64)
    leaf_of[prims[prims >= 0]] = np.nonzero(prims >= 0)[0] // 8
    i, j = _near_pairs(c, 2 * r.max())
    dist = np.linalg.norm(c[j] - c[i], axis=1)
    meet = (leaf_of[i] != leaf_of[j]) & (dist < r[i] + r[j]) & \
        (dist > np.abs(r[i] - r[j]))
    check(meet.any(), 'sphere_edge_rays: no two spheres of different leaves '
          'meet')
    g = np.random.default_rng(seed)
    k = g.choice(np.nonzero(meet)[0], n)
    i, j, dist = i[k], j[k], dist[k]
    axis = (c[j] - c[i]) / dist[:, None]
    along = (dist ** 2 + r[i] ** 2 - r[j] ** 2) / (2 * dist)
    rc = np.sqrt(np.maximum(r[i] ** 2 - along ** 2, 0.0))
    ref = np.where(np.abs(axis[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]],
                   [[1.0, 0.0, 0.0]])
    u = ref - (ref * axis).sum(1, keepdims=True) * axis
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(axis, u)
    theta = g.uniform(0.0, 2 * np.pi, n)
    theta[: n // 4] = np.pi * (g.uniform(size=n // 4) < 0.5)
    aim = c[i] + along[:, None] * axis + rc[:, None] * (
        np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v)
    out = (aim - c[i]) / r[i, None] + (aim - c[j]) / r[j, None]
    out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-30)
    d = -out + 0.6 * g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    outside = (((d * (aim - c[i])).sum(1) < 0)
               & ((d * (aim - c[j])).sum(1) < 0))[:, None]
    d = np.where(outside, d, -out).astype(np.float32)
    reach = g.uniform(1.0, 20.0, n) * r.mean()
    org = (aim - d * reach[:, None]).astype(np.float32)
    seg = (reach * np.where(np.arange(n) % 2 == 0, 0.999, 1.001)).astype(
        np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (org, d, seg))


def edge_forms(where, target, kind, rays, card, strict=True):
    """One form of ``target`` (a tree of ``kind``) on edge rays (org, dir,
    time or None, seg: edge_rays or sphere_edge_rays), closest-hit and
    any-hit, against its plain walk: the rays on which any of (t, prim, u,
    v, slot), or the blocked flag, differ in a bit, two launches
    bit-identical.  strict: no ray may differ.  Returns the counts."""
    from corona13_tpu_torch.ops import trace_cuda
    org, d, tm, seg = rays
    n = org.shape[0]
    t = torch.full((n,), MAX_DIST, device=org.device)
    form = trace_cuda._form_of(target, kind)
    key = kind if form == 'wide' else form
    out = {}
    for mode, t_max in (('closest_hit', t), ('any_hit', seg)):
        run = lambda f: f(target, kind, org, d, t_max, time=tm)
        k, k2 = run(getattr(trace_cuda, mode)), run(getattr(trace_cuda, mode))
        p = run(getattr(trace_cuda, mode + '_plain'))
        tup = (lambda x: (x,)) if mode == 'any_hit' else (lambda x: x)
        bits = lambda x: _bits(x) if x.dtype == torch.float32 else x
        differ = torch.zeros(n, dtype=torch.bool, device=org.device)
        for a, b in zip(tup(k), tup(p)):
            differ |= bits(a) != bits(b)
        same = all(torch.equal(bits(a), bits(b))
                   for a, b in zip(tup(k), tup(k2)))
        found = k if mode == 'any_hit' else k[1] >= 0
        out[mode] = dict(rays=n, hit_share=float(found.float().mean()),
                         differ=int(differ.sum()), same_twice=same)
        print(f'  {where} edge rays, {key} {mode.replace("_", "-")}: {n} '
              f'rays aimed at points two leaves share, hit share '
              f'{out[mode]["hit_share"]:.4f}; rays whose bits differ from the '
              f'plain walk {out[mode]["differ"]}; two launches identical '
              f'{same}, on {card}', flush=True)
        check(same, f'{where} edge rays {mode}: two launches differ')
        if strict:
            check(out[mode]['differ'] == 0,
                  f'{where} edge rays {mode}: {out[mode]["differ"]} rays '
                  f'differ from the plain walk')
    return out


def leaf_pop_bytes(bvh):
    """Record bytes a moving leaf pop reads, mean over the tree's leaves:
    (before, now).  Before: 8 rows of two 48 B records (shutter open and
    close).  Now: the filled rows' shutter-open records, and a second
    record for each row that moves; None where the tree carries the old
    records (scripts/trace_times.py --root with an older checkout)."""
    old = 8 * 2 * 48
    if bvh.kleaves_t1 is None or bvh.kleaves_t1.dim() != 2:
        return old, None
    words = bvh.kleaves.reshape(-1, 8, 12).contiguous().view(torch.int32)
    filled = words[:, 0, 11].double()
    moving = (words[:, :, 7] >= 0).double().sum(dim=1)
    return old, float(((filled + moving) * 48).mean())


def frame_shapes_phase(hair, mb, card):
    """Phase 8c: the line and moving forms at the hair and 0002_mb frames'
    own shapes: every launch of one 1024x576 progression captured and held
    by frame_forms (time, bound, share, launches a frame), the line
    counters launch on the hair frame's first bounce and first shadow rays
    (kernel pops a ray beside the plain walk's), and one hair progression
    under torch.profiler (device ms of each form); the moving form on rays
    aimed at the 0002_mb plane's shared edges (edge_forms)."""
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'the line and moving forms at the hair and 0002_mb frames\' '
          f'shapes, {W}x{H}, mf=4, max_verts=6, NEE, on {card}')
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    kept = frame_calls(hair, cfg)
    out = {'hair': frame_forms('hair', kept, ('line_closest', 'line_any'),
                               card),
           'pops': {}}
    for mode, calls in kept.items():
        target, _, args, kw = next(c for c in calls if c[1] == 'line')
        carry, t = kw['carry'], args[2]
        any_hit = mode == 'any_hit'
        # the line launch starts where the triangle launch left the ray
        start = torch.where(carry, 0.0, t) if any_hit else carry[0]
        out['pops'][mode] = line_counts(
            f'hair first {"shadow" if any_hit else "bounce"}', target,
            kw['prim_offset'], 'any' if any_hit else 'closest',
            (args[0], args[1], start.contiguous(), args[3],
             args[4] if any_hit else None), card, time_it=False)
    del kept
    out['0002_mb'] = frame_forms('0002_mb', frame_calls(mb, cfg),
                                 ('moving_closest', 'moving_any'), card)
    out['0002_mb_edges'] = edge_forms(
        '0002_mb', mb.geom.tri_bvh, 'moving',
        edge_rays(mb.geom, 1 << 16, 21, mb.device), card)
    out['hair_profile'] = _profile_frame('hair frame', hair, cfg, card)
    return out


def plane_edges_phase(plane, card, skip=True):
    """The plane scene's static tree on edge_rays (no ray times): its deep
    and skip forms (the tree without a wide layout as forms_phase builds
    it) against the plain skip-link walk, held bit for bit where
    EXACT_KINDS names them; the wide walk of the same tree (the TPU
    kernel's order and winner) against its own plain version, counted.
    skip=False: no skip form (scripts/trace_times.py --root with a
    checkout from before it).  Returns the counts."""
    phase(f'edge rays of the plane scene\'s static tree, on {card}')
    b = plane.geom.tri_bvh
    org, d, _, seg = edge_rays(plane.geom, 1 << 16, 21, plane.device)
    rays = (org, d, None, seg)
    out = {'deep': edge_forms('plane', _deep_tree(b), 'tri', rays, card,
                              strict='deep' in EXACT_KINDS)}
    if skip:
        out['skip'] = edge_forms('plane', _skip_tree(b), 'tri', rays, card,
                                 strict='skip' in EXACT_KINDS)
    out['wide'] = edge_forms('plane', b, 'tri', rays, card, strict=False)
    return out


def sphere_edges(geoms, card, strict):
    """The sphere form of each of ``geoms`` ({name: geometry}) on 65,536
    sphere_edge_rays, against its plain walk (edge_forms)."""
    out = {}
    for name, geom in geoms.items():
        org, d, seg = sphere_edge_rays(geom, 1 << 16, 21, geom.sph_c.device)
        out[name] = edge_forms(name, geom.sph_bvh, 'sphere',
                               (org, d, None, seg), card, strict=strict)
    return out


def sphere_frame_phase(dev, card):
    """Phase 8d: the sphere frame (_sphere_scene: 65,536 spheres, the
    sphere BVH form) at full width, launch counts asserted; every sphere
    launch of one progression held against its plain version and timed at
    the frame's own shapes (frame_forms); its paths on the card against the
    CPU at 64x36, read against the bar of 0.99 and reported; the sphere form on rays aimed at points two spheres of
    different leaves share (sphere_edge_rays), on the frame's spheres and
    on phase 3b's soup; one progression under torch.profiler."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    t0 = time.time()
    sc = scene_mod.fit_film(_sphere_scene(dev), W, H)
    b = sc.geom.sph_bvh
    print(f'sphere scene: {sc.geom.n_spheres} spheres, sphere BVH of '
          f'{b.knodes.shape[0]} wide nodes (stack depth {b.stack_depth}) '
          f'built in {time.time() - t0:.1f} s', flush=True)
    res, lit, launches, rays = render_phase(
        f'spheres ({sc.geom.n_spheres} spheres)', sc, 2, card,
        forms=('closest', 'any', 'sphere_closest', 'sphere_any'))
    check(lit > 0.5, f'sphere frame: only {lit} of the pixels are lit')
    phase(f'the sphere form at the sphere frame\'s shapes, {W}x{H}, mf=4, '
          f'max_verts=6, NEE, on {card}')
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    forms = frame_forms('spheres', frame_calls(sc, cfg),
                        ('sphere_closest', 'sphere_any'), card)
    soup = trace_mod.make_device_geometry(**_sphere_soup(1 << 16, 9),
                                          device=dev)
    edges = sphere_edges({'spheres': sc.geom, 'sphere soup': soup}, card,
                         strict='sphere' in EXACT_KINDS)
    del soup
    profile = _profile_frame('sphere frame', sc, cfg, card)
    # the card against the CPU, read against the bar of 0.99 and reported,
    # not gated: a bounce off a small sphere carries an ulp of its hit
    # point and normal into the next vertex (torch's CPU sqrt is not
    # correctly rounded; on 300 of these spheres the JAX package agrees
    # with itself, FMA on against off, on about 97% of paths:
    # tests/test_torch_sphere_form.py)
    close = paths_against_cpu('sphere paths', _sphere_scene, 64, 36, dev,
                              gate=False, max_verts=6)
    print(f'sphere paths: card against CPU {close:.4f}, '
          f'{"at or above" if close >= 0.99 else "BELOW"} the bar of 0.99',
          flush=True)
    return dict(frame_s=res.seconds / 2, rays=rays,
                mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                mean=float(res.image_xyz.mean()), launches=launches,
                frame_forms=forms, edges=edges, profile=profile,
                paths_vs_cpu=close, paths_vs_cpu_meets_bar=close >= 0.99)


def zoom_tree_report(b):
    """The zoom tree's depths: (wdepth, its wide stack need wdepth*7 + 8,
    binary levels), printed."""
    from corona13_tpu_torch.ops import bvh as bvh_mod
    from corona13_tpu_torch.ops import trace_cuda
    nodes, prims = b.nodes.cpu().numpy(), b.leaf_prims.cpu().numpy()
    wdepth = bvh_mod.collapse8(bvh_mod.flat_from_nodes(nodes, prims))[2]
    # (scripts/trace_times.py --root: a checkout from before the deep
    # walk does not count the levels)
    levels = trace_cuda.bin_depth(nodes) if hasattr(trace_cuda, 'bin_depth') \
        else None
    print(f'zoom tree: {int((prims >= 0).sum())} triangles, {b.n_nodes} '
          f'binary nodes, form {trace_cuda._form_of(b, "tri")}; wdepth '
          f'{wdepth}, wide stack need {wdepth * 7 + 8} (limit '
          f'{trace_cuda.MAX_STACK}), binary depth {levels} levels',
          flush=True)
    return wdepth, wdepth * 7 + 8, levels


def deep_forms(where, scene, cfg, card, skip=True, strict=True):
    """The deep launches of one progression of ``scene`` (frame_calls)
    held and timed at the frame's shapes (frame_forms) and, with ``skip``,
    the same launches by the skip form of the same tree (_skip_tree); then
    each form on 65,536 edge_rays of the tree (edge_forms, no ray allowed
    to differ where ``strict`` and EXACT_KINDS name the form).  Returns
    (frame_forms' records by key, edge_forms' counts by form)."""
    b = scene.geom.tri_bvh
    kept = frame_calls(scene, cfg)
    forms = frame_forms(where, kept, ('deep_closest', 'deep_any'), card)
    trees = {'deep': b}
    if skip:
        trees['skip'] = _skip_tree(b)
        forms.update(frame_forms(where, {
            m: [(trees['skip'],) + c[1:] for c in calls]
            for m, calls in kept.items()}, ('skip_closest', 'skip_any'),
            card))
    del kept
    org, d, _, seg = edge_rays(scene.geom, 1 << 16, 21, scene.device)
    edges = {f: edge_forms(where, t, 'tri', (org, d, None, seg), card,
                           strict=strict and f in EXACT_KINDS)
             for f, t in trees.items()}
    return forms, edges


def _frame_seconds(scene, cfg, warm=2, timed=5):
    """Seconds of ``timed`` progressions through render.render (one sample
    each, ending with the image on the host) after ``warm``."""
    from corona13_tpu_torch import render as render_mod
    secs = []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        render_mod.render(scene, cfg, spp=1, batch=1)
        torch.cuda.synchronize()
        if i >= warm:
            secs.append(time.perf_counter() - t0)
    return secs


def zoom_frame_phase(dev, card):
    """Phase 8e: the zoom frame (_zoom_scene: a 65,536-triangle log-spiral
    ribbon whose tree is too deep for the wide stack) at full width: its
    tree's depths, a render with deep_closest and deep_any asserted at 5
    launches a frame each and nothing else, frame s (min / median / max)
    and Mrays/s; every deep launch of one progression held bit for bit
    against the plain walk and timed at the frame's own shapes
    (frame_forms), and the same launches by the skip form (the tree over
    the deep stack's limit, laid out without deep records) beside them;
    both forms on rays aimed at edges two of the tree's leaves share
    (edge_rays); one progression under torch.profiler; its paths on the
    card against the CPU at 64x36."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.ops import trace_cuda
    from corona13_tpu_torch.samplers import pt as pt_mod
    t0 = time.time()
    sc = scene_mod.fit_film(_zoom_scene(dev), W, H)
    b = sc.geom.tri_bvh
    print(f'zoom scene built in {time.time() - t0:.1f} s', flush=True)
    depths = zoom_tree_report(b)
    check(trace_cuda._form_of(b, 'tri') == 'deep',
          'the zoom tree did not take the deep form')
    res, lit, launches, rays = render_phase(
        f'zoom ({sc.geom.n_tris} triangles)', sc, 2, card,
        forms=('deep_closest', 'deep_any'))
    check(lit > 0.5, f'zoom frame: only {lit} of the pixels are lit')
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    secs = _frame_seconds(sc, cfg)
    print(f'zoom frame: {_spread(secs)} s a frame over {len(secs)} frames, '
          f'{rays / 2 / float(np.median(secs)) / 1e6:.2f} Mrays/s at the '
          f'median, on {card}', flush=True)
    phase(f'the deep and skip forms at the zoom frame\'s shapes, {W}x{H}, '
          f'mf=4, max_verts=6, NEE, on {card}')
    forms, edges = deep_forms('zoom', sc, cfg, card)
    profile = _profile_frame('zoom frame', sc, cfg, card)
    close = paths_against_cpu('zoom paths', _zoom_scene, 64, 36, dev,
                              max_verts=6)
    return dict(frame_s=res.seconds / 2, frame_s_spread=secs, rays=rays,
                mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                mean=float(res.image_xyz.mean()), launches=launches,
                wdepth=depths[0], wide_stack_need=depths[1],
                binary_levels=depths[2], frame_forms=forms, edges=edges,
                profile=profile, paths_vs_cpu=close)


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


def _in_turns(fns, reps=20):
    """Card ms of each of ``fns`` (name -> fn of an input set), timed by
    _time_ms in turns, forwards then backwards: the mean of its two."""
    ms = {k: 0.0 for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k] += _time_ms(fns[k], 2, reps) / 2
    return ms


def counters_phase(cases, kres, card):
    """want_counters at the main path's shapes: the union kernel (the TPU
    kernel's walk of each 128-ray tile) on the cornell, plane and soup
    BVHs, bounce and shadow rays.  Its own path is one launch per case
    with the counts reset before and read after; then each case is held to
    the plain union walk on the card (every block's counts, hits as phase
    3, and the share of rays equal in every bit), launched twice
    (bit-identical), and timed in turns with the per-ray walk that counts
    each ray's own pops (simple_walk, thread i on ray i, held to the plain
    per-ray walk's pops) and the render path's persistent launch.  Lane
    share: the per-ray pops over the union's pops times its tile's live
    lanes, the share of a packet's lanes that a pop keeps busy.  The union
    kernel's bound counts the operations of its pops on the lanes open at
    each pop (union_lanes), on occupied children and rows; the per-ray
    rows' bounds (the closest / any rows of the kernels line) count the
    per-ray pops."""
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'counters: the union walk against plain, beside the per-ray and '
          f'the persistent walks, {N_RAYS} rays per call, on {card}')
    names = [f'{b}/{k}' for b in ('cornell', 'plane', 'soup')
             for k in ('bounce', 'shadow')]
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    outs = [trace_cuda.traverse_tris(cases[n][0], *cases[n][2][0],
                                     any_hit=cases[n][1], want_counters=True)
            for n in names]
    torch.cuda.synchronize()
    launches = dict(trace_cuda.launches)
    print(f'union launches {launches} (expected {len(names)} counters)',
          flush=True)
    check({k: v for k, v in launches.items() if v}
          == {'counters': len(names)}, f'counter launch counts {launches}')
    before = dict(trace_cuda.launches)
    simples = [trace_cuda.simple_walk(cases[n][0], *cases[n][2][0],
                                      any_hit=cases[n][1]) for n in names]
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in trace_cuda.launches.items()
             if v != before[k]}
    check(moved == {'tri_counters': len(names)},
          f'per-ray walk launch counts {moved}')
    launches['tri_counters'] = moved['tri_counters']
    res = {}
    for name, out, simple_out in zip(names, outs, simples):
        b, ah, argsets = cases[name]
        union = lambda s: trace_cuda.traverse_tris(
            b, *argsets[s], any_hit=ah, want_counters=True)
        again = union(0)
        torch.cuda.synchronize()
        check(all(torch.equal(_bits(x), _bits(y)) for x, y in zip(out, again)),
              f'{name}: two union launches differ')
        k = [x.cpu().numpy() for x in out]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p = trace_cuda.union_walk_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                        *argsets[0], any_hit=ah,
                                        tile_stats=True)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        tile_stats = [x.cpu() for x in p[7:]]
        p = [x.cpu().numpy() for x in p[:7]]
        check(k[5].shape == (N_RAYS // 1024,), f'{name}: counter shape')
        blocks_eq = float(((k[5] == p[5]) & (k[6] == p[6])).mean())
        check(blocks_eq == 1.0, f'{name}: counters differ on '
              f'{1 - blocks_eq:.4%} of blocks')
        agree, err = _compare_hits(k, p, ah, name)
        as_int = lambda x: x.view(np.int32) if x.dtype == np.float32 else x
        bits_eq = float(np.logical_and.reduce(
            [as_int(x) == as_int(y) for x, y in zip(k[:5], p[:5])]).mean())
        # the per-ray walk against its plain version: each ray's pops
        s = [x.cpu().numpy() for x in simple_out]
        start.record()
        ps = trace_cuda.traverse_tris_plain(
            b.wbounds, b.wlinks, b.leaf_packed, *argsets[0], any_hit=ah,
            ray_pops=True)
        end.record()
        torch.cuda.synchronize()
        simple_plain_ms = start.elapsed_time(end)
        ps = [x.cpu().numpy() for x in ps]
        check((s[5] == ps[5]).all() and (s[6] == ps[6]).all(),
              f'{name}: the per-ray walk\'s pops differ from plain')
        s_agree, s_err = _compare_hits(s, ps, ah, f'{name} per-ray walk')
        inner_r, leaf_r = int(s[5].sum()), int(s[6].sum())
        t_iters, t_leafs, live, inner_open, leaf_open = tile_stats
        live = live.double()
        # of the lanes a pop tests, the share whose ray is still open
        open_share = float((inner_open + leaf_open).sum()) / max(
            float(((t_iters + t_leafs) * live).sum()), 1)
        simple = lambda i: trace_cuda.simple_walk(b, *argsets[i], any_hit=ah)
        if ah:
            pers = lambda i: (trace_cuda.occluded_tris(b, *argsets[i]),)
        else:
            pers = lambda i: trace_cuda.traverse_tris(b, *argsets[i])
        ms = _in_turns({'union': union, 'simple': simple, 'persistent': pers})
        m = kres['any' if ah else 'closest'][name]
        t_tensor = torch.is_tensor(argsets[0][2])
        lane_share, ubound, uby = union_lanes(b, N_RAYS, m['alive'],
                                              t_tensor, tile_stats,
                                              inner_r, leaf_r)
        bound, by = _bound_ms(b, N_RAYS, m['alive'], t_tensor, 1,
                              1 if ah else 28, inner_r, leaf_r)
        sbound, sby = _bound_ms(b, N_RAYS, m['alive'], t_tensor, 1, 36,
                                inner_r, leaf_r)
        n_tiles = N_RAYS // 128
        print(f'  {name:14s} {"any" if ah else "closest"}-hit: blocks equal '
              f'{blocks_eq:.6f}, prim agree {agree:.6f}, rays equal in every '
              f'bit {bits_eq:.6f}, max |dt| {err:.3g}; union pops a tile '
              f'{int(k[5].sum()) / n_tiles:.2f} inner / '
              f'{int(k[6].sum()) / n_tiles:.2f} leaf, per-ray pops a ray '
              f'{inner_r / N_RAYS:.2f} inner / {leaf_r / N_RAYS:.2f} leaf, '
              f'live lanes a tile {live.mean():.2f}, open at a pop '
              f'{open_share:.4f} of them, lane share {lane_share:.4f}; '
              f'union {ms["union"]:.4f} ms (bound '
              f'{ubound:.4f} by {uby}, share {ubound / ms["union"]:.4f}), '
              f'per-ray {ms["simple"]:.4f} ms, persistent '
              f'{ms["persistent"]:.4f} ms (bound {bound:.4f} by {by}, share '
              f'{bound / ms["persistent"]:.3f}); plain union {plain_ms:.1f} '
              f'ms', flush=True)
        res[name] = dict(ms=ms['union'], ms_simple=ms['simple'],
                         ms_persistent=ms['persistent'], plain_ms=plain_ms,
                         max_abs_err=err, agree=agree, blocks_equal=blocks_eq,
                         bits_equal_share=bits_eq,
                         union_inner_per_tile=int(k[5].sum()) / n_tiles,
                         union_leaf_per_tile=int(k[6].sum()) / n_tiles,
                         live_per_tile=float(live.mean()),
                         open_share=open_share,
                         inner_per_ray=inner_r / N_RAYS,
                         leaf_per_ray=leaf_r / N_RAYS, lane_share=lane_share,
                         union_bound_ms=ubound, union_bound_by=uby,
                         bound_ms=bound, bound_by=by, simple_bound_ms=sbound,
                         simple_bound_by=sby, simple_agree=s_agree,
                         simple_max_abs_err=s_err,
                         simple_plain_ms=simple_plain_ms)
    print('tolerance: iters and leafs equal on every block; hits as phase 3 '
          '(prim and slot on >= 99.9% of rays, t rtol 1e-6), the share of '
          'rays equal in every bit printed; two union launches '
          'bit-identical; the per-ray walk\'s pops equal the plain per-ray '
          'walk\'s on every ray', flush=True)
    return res, launches


# --- phase 4/5: the main path ----------------------------------------------

def render_phase(name, scene, spp, gpu_name, max_verts=6,
                 forms=('closest', 'any'), per_bounce=None, **kw):
    """One render through render.render with the launch counts zeroed just
    before and read just after: every form in ``forms`` must have been
    launched once a bounce (``per_bounce[form]`` times where given), and no
    other."""
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
    expect = {k: per * (per_bounce or {}).get(k, 1) for k in forms}
    moved = {k: v for k, v in launches.items() if v}
    print(f'kernel launches {moved} (expected {expect})', flush=True)
    check(moved == expect, f'launch counts {moved}, expected {expect}')
    rays = 0
    pix = torch.arange(W * H, device=scene.device)
    for s in range(spp):
        rays += int(pt_mod.count_rays(scene, cfg, s, pix))
    print(f'{name}: {res.seconds / spp:.4f} s per frame, {rays} rays, '
          f'{rays / res.seconds / 1e6:.2f} Mrays/s on {gpu_name}', flush=True)
    return res, lit, launches, rays


# --- phases 7-10: the .nra2 scene path with participating media ------------

def _scene_path(name):
    return os.path.join(SCENES, name, 'test.nra2')


def _down(img, f):
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


def golden_phase(dev):
    """The JAX package's golden gates (tests/test_golden.py:134-173 and,
    for 0002_mb, :243-253) on the card: same sizes, mf, max_verts, spp,
    fit_film and bounds."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.io import pfm as pfm_io
    from corona13_tpu_torch.samplers import pt as pt_mod
    out = {}
    for name, (w, h, mv, mf, spp, batch, down, max_rmse, max_mean) in {
            '0031_hete': (64, 40, 12, 2, 16, 8, 4, 0.06, 0.12),
            '0030_subsurf': (128, 80, 8, 4, 12, 4, 2, 0.2, 0.05),
            '0002_mb': (128, 80, 6, 4, 24, 8, 2, 0.35, 0.05)}.items():
        phase(f'golden gate {name}: {w}x{h}, mf={mf}, max_verts={mv}, '
              f'{spp} spp')
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


def _hair_scene(dev, n_fibers=1 << 16, seed=0, radii=(0.1, 0.06)):
    """n_fibers HAIR fibres (tapered cones, 1-2 units tall, ``radii`` at
    root and tip) standing on a 20 x 25 diffuse ground under a constant sky
    and a small area light, made from ``seed``; the camera at the origin
    looks down +z over it.  The fibres are thick on purpose: the cone
    test's c = |o|^2 - ya^2 - s^2 cancels when a ray starts far from a thin
    fibre, so an ulp between the card's and the CPU's sin, cos or sqrt
    moves such a hit by percents and each bounce multiplies it (radii
    (0.03, 0.01): 97.0% of the 64x36 paths equal the CPU's; (0.06, 0.03):
    99.3%; (0.1, 0.06): 99.7%; NVIDIA H100 80GB HBM3, 700.00 W)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.io import cam as cam_io
    g = np.random.default_rng(seed)
    M = scene_mod._ResolvedMat
    mats = [M(d_rgb=(0.5, 0.5, 0.5)),
            M(kind=scene_mod.HAIR, d_rgb=(0.6, 0.4, 0.3),
              g_rgb=(0.3, 0.3, 0.3), roughness=0.2),
            M(e_rgb=(30.0, 30.0, 30.0))]
    y0 = -3.0
    ground = np.array([[[-10, y0, 5], [10, y0, 30], [10, y0, 5]],
                       [[-10, y0, 5], [-10, y0, 30], [10, y0, 30]]],
                      np.float32)
    light = np.array([[[-1, 6, 14], [1, 6, 14], [1, 6, 16]],
                      [[-1, 6, 14], [1, 6, 16], [-1, 6, 16]]], np.float32)
    root = np.stack([g.uniform(-9, 9, n_fibers), np.full(n_fibers, y0),
                     g.uniform(6, 29, n_fibers)], axis=-1)
    tip = root + np.stack([g.normal(0, 0.25, n_fibers),
                           g.uniform(1.0, 2.0, n_fibers),
                           g.normal(0, 0.25, n_fibers)], axis=-1)
    cam = cam_io.CameraData(
        pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
        orient=np.array([1, 0, 0, 0], np.float32),
        orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    return testing.assemble_scene(
        np.concatenate([ground, light]), np.array([0, 0, 2, 2], np.int32),
        mats, cam, sky_rgb=(1.0, 1.0, 1.0),
        line_vtx=np.stack([root, tip], axis=1).astype(np.float32),
        line_radii=np.tile(np.array([radii], np.float32),
                           (n_fibers, 1)),
        line_sh=np.ones(n_fibers, np.int32), device=dev)


def _sphere_inputs(n_spheres=1 << 16, seed=0):
    """The sphere frame's scene as arrays, for either package's
    assemble_scene: (triangles, their shaders, materials as _ResolvedMat
    keywords, CameraData keywords, the sphere and sky keywords).
    n_spheres spheres (centres uniform over x in [-9, 9], y in [-3, 1], z
    in [6, 29], radii uniform in [0.05, 0.25]; a quarter rough METAL, the
    rest DIFFUSE, none dielectric) on the hair scene's 20 x 25 diffuse
    ground under its constant sky and small area light, seen by its
    camera, made from ``seed``."""
    from corona13_tpu_torch import scene as scene_mod
    g = np.random.default_rng(seed)
    mats = [dict(d_rgb=(0.5, 0.5, 0.5)), dict(e_rgb=(30.0, 30.0, 30.0)),
            dict(d_rgb=(0.6, 0.45, 0.3)),
            dict(kind=scene_mod.METAL, g_rgb=(1.0, 1.0, 1.0), roughness=0.3)]
    y0 = -3.0
    ground = np.array([[[-10, y0, 5], [10, y0, 30], [10, y0, 5]],
                       [[-10, y0, 5], [-10, y0, 30], [10, y0, 30]]],
                      np.float32)
    light = np.array([[[-1, 6, 14], [1, 6, 14], [1, 6, 16]],
                      [[-1, 6, 14], [1, 6, 16], [-1, 6, 16]]], np.float32)
    c = np.stack([g.uniform(-9, 9, n_spheres), g.uniform(-3, 1, n_spheres),
                  g.uniform(6, 29, n_spheres)], axis=-1).astype(np.float32)
    rad = g.uniform(0.05, 0.25, n_spheres).astype(np.float32)
    sh = np.where(g.uniform(size=n_spheres) < 0.25, 3, 2).astype(np.int32)
    cam = dict(pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
               orient=np.array([1, 0, 0, 0], np.float32),
               orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    return (np.concatenate([ground, light]), np.array([0, 0, 1, 1], np.int32),
            mats, cam, dict(sky_rgb=(1.0, 1.0, 1.0), sph_c=c, sph_r=rad,
                            sph_sh=sh))


def _sphere_scene(dev, n_spheres=1 << 16, seed=0):
    """_sphere_inputs assembled on ``dev``: a particle render, whose sphere
    BVH the wide walk's sphere form serves (more than
    trace.BRUTE_FORCE_MAX spheres)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.io import cam as cam_io
    tri_v, tri_sh, mats, cam, kw = _sphere_inputs(n_spheres, seed)
    return testing.assemble_scene(
        tri_v, tri_sh, [scene_mod._ResolvedMat(**m) for m in mats],
        cam_io.CameraData(**cam), device=dev, **kw)


def zoom_ribbon(n_tris=1 << 16, shrink=0.99902, step=0.02):
    """A continuous log-spiral ribbon of n_tris triangles centred at the
    world origin: sample k at radius R = shrink**k and angle a = step*k
    has the inner edge point (R cos a, R sin a, 0.05 R sin 7a) and the
    outer (1.3 R cos a, 1.3 R sin a, 0.05 R cos 7a); consecutive samples
    make (a_k, b_k, a_k+1) and (a_k+1, b_k, b_k+1), so consecutive
    triangles share edges.  [n_tris, 3, 3] f32 (computed in f64).  Its
    triangles shrink by orders of magnitude towards the centre (1e-14
    across at the defaults), which gives a binned-SAH tree that peels off
    a few large triangles at every level: too deep for the wide stack."""
    k = np.arange(n_tris // 2 + 1, dtype=np.float64)
    rad, th = shrink ** k, step * k
    a = np.stack([rad * np.cos(th), rad * np.sin(th),
                  0.05 * rad * np.sin(7 * th)], axis=-1)
    b = np.stack([1.3 * rad * np.cos(th), 1.3 * rad * np.sin(th),
                  0.05 * rad * np.cos(7 * th)], axis=-1)
    tri = np.stack([np.stack([a[:-1], b[:-1], a[1:]], axis=1),
                    np.stack([a[1:], b[:-1], b[1:]], axis=1)], axis=1)
    return tri.reshape(-1, 3, 3).astype(np.float32)


def _zoom_inputs(n_tris=1 << 16, seed=0):
    """The zoom frame's scene as arrays, for either package's
    assemble_scene: (triangles, their shaders, materials as _ResolvedMat
    keywords, CameraData keywords, the sky keyword).  zoom_ribbon(n_tris)
    at the origin, a quarter of its triangles rough METAL and the rest
    DIFFUSE (none dielectric, drawn from ``seed``), a two-triangle diffuse
    ground behind it (z = -0.5, +-6), a two-triangle area light facing it
    from above the camera (z = 5), a constant sky; the camera on the +z
    axis at z = 3 looking at the origin, its film spanning a radius of
    about 1.3 there."""
    from corona13_tpu_torch import scene as scene_mod
    g = np.random.default_rng(seed)
    ribbon = zoom_ribbon(n_tris)
    mats = [dict(d_rgb=(0.5, 0.5, 0.5)), dict(e_rgb=(30.0, 30.0, 30.0)),
            dict(d_rgb=(0.6, 0.45, 0.3)),
            dict(kind=scene_mod.METAL, g_rgb=(1.0, 1.0, 1.0), roughness=0.3)]
    z0, s = -0.5, 6.0
    ground = np.array([[[-s, -s, z0], [s, -s, z0], [s, s, z0]],
                       [[-s, -s, z0], [s, s, z0], [-s, s, z0]]], np.float32)
    light = np.array([[[-1, -1, 5], [1, 1, 5], [1, -1, 5]],
                      [[-1, -1, 5], [-1, 1, 5], [1, 1, 5]]], np.float32)
    sh = np.where(g.uniform(size=len(ribbon)) < 0.25, 3, 2).astype(np.int32)
    # 180 degrees about y: the camera looks down -z
    cam = dict(pos=np.array([0, 0, 3], np.float32),
               pos_t1=np.array([0, 0, 3], np.float32),
               orient=np.array([0, 0, 1, 0], np.float32),
               orient_t1=np.array([0, 0, 1, 0], np.float32), focus=3.0,
               focal_length=0.24)
    return (np.concatenate([ribbon, ground, light]),
            np.concatenate([sh, np.array([0, 0, 1, 1], np.int32)]), mats,
            cam, dict(sky_rgb=(1.0, 1.0, 1.0)))


def _zoom_scene(dev, n_tris=1 << 16, seed=0):
    """_zoom_inputs assembled on ``dev``: one triangle tree (ribbon,
    ground and light) with no wide layout, walked by the deep form."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.io import cam as cam_io
    tri_v, tri_sh, mats, cam, kw = _zoom_inputs(n_tris, seed)
    return testing.assemble_scene(
        tri_v, tri_sh, [scene_mod._ResolvedMat(**m) for m in mats],
        cam_io.CameraData(**cam), device=dev, **kw)


def paths_against_cpu(name, build, w, h, dev, gate=True, **cfg_kw):
    """sample_paths of one scene (``build(device)``) on the card (kernels)
    against the CPU (plain versions): >= 99% of paths equal at rtol 1e-4 /
    atol 1e-6.  With gate=False the share is printed and returned, not
    held to the bar."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'{name} on the card against the CPU, {w}x{h}')
    cfg = pt_mod.PTConfig(width=w, height=h, mf=4, use_nee=True, **cfg_kw)
    out = []
    for d in (dev, torch.device('cpu')):
        sc = scene_mod.fit_film(build(d), w, h)
        pix = torch.arange(w * h, device=d)
        out.append(pt_mod.sample_paths(sc, cfg, 5, pix)[0].cpu().numpy())
    close = float(np.isclose(out[0], out[1], rtol=1e-4, atol=1e-6)
                  .all(axis=-1).mean())
    lit = float((out[1] > 0).any(axis=-1).mean())
    print(f'paths agreeing at rtol 1e-4 / atol 1e-6: {close:.4f} '
          f'({"bar 0.99" if gate else "a reading, no bar"}); '
          f'means {out[0].mean():.6g} vs {out[1].mean():.6g}; paths with '
          f'signal {lit:.4f}', flush=True)
    check(close >= 0.99 or not gate,
          f'{name}: card and CPU paths agree on only {close}')
    check(lit > 0.05, f'{name}: only {lit} of the paths carry signal')
    return close


def prims_phase(dev, card):
    """Phase 8b: 0002_mb (moving triangles) and the hair frame (a line
    BVH) at full width, launch counts asserted, and each on the card
    against the CPU."""
    from corona13_tpu_torch import scene as scene_mod
    out = {}
    load_mb = lambda d: scene_mod.load_scene(_scene_path('0002_mb'),
                                             device=d)[0]
    mb = scene_mod.fit_film(load_mb(dev), W, H)
    check(mb.geom.has_motion and mb.geom.tri_bvh.kleaves_t1 is not None,
          '0002_mb loaded without its shutter-close triangles')
    res, lit, launches, rays = render_phase(
        f'0002_mb ({mb.geom.n_tris} triangles, moving)', mb, 2, card,
        forms=('moving_closest', 'moving_any'))
    out['0002_mb'] = dict(frame_s=res.seconds / 2, rays=rays,
                          mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                          mean=float(res.image_xyz.mean()), launches=launches,
                          paths_vs_cpu=paths_against_cpu(
                              '0002_mb paths', load_mb, 64, 40, dev,
                              max_verts=6))
    t0 = time.time()
    hair = scene_mod.fit_film(_hair_scene(dev), W, H)
    print(f'hair scene: {hair.geom.n_lines} fibres, line BVH of '
          f'{hair.geom.line_bvh.knodes.shape[0]} wide nodes (stack depth '
          f'{hair.geom.line_bvh.stack_depth}) built in {time.time() - t0:.1f} '
          f's', flush=True)
    res, lit, launches, rays = render_phase(
        f'hair ({hair.geom.n_lines} fibres)', hair, 2, card,
        forms=('closest', 'any', 'line_closest', 'line_any'))
    check(lit > 0.5, f'hair frame: only {lit} of the pixels are lit')
    out['frame_forms'] = frame_shapes_phase(hair, mb, card)
    out['hair'] = dict(frame_s=res.seconds / 2, rays=rays,
                       mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                       mean=float(res.image_xyz.mean()), launches=launches,
                       paths_vs_cpu=paths_against_cpu(
                           'hair paths', _hair_scene, 64, 36, dev,
                           max_verts=6),
                       # fibres as thin as real hair: see _hair_scene; the
                       # share is kept in sight so that a change to the cone
                       # test shows here, and is held to no bar
                       thin_paths_vs_cpu=paths_against_cpu(
                           'hair paths, thin fibres (radii 0.03 to 0.01)',
                           lambda d: _hair_scene(d, radii=(0.03, 0.01)), 64,
                           36, dev, gate=False, max_verts=6))
    return out


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


# --- phases 11-14: skies, compaction, gradients, dbor and vis ---------------

SUN_DIR = (0.3, 0.2, 0.9)
GB = 1e9


def _moved(obj, dev):
    """A dataclass of tensors with every tensor field on ``dev``."""
    import dataclasses
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


def _zero_launches():
    from corona13_tpu_torch.ops import trace_cuda
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0


def _read_launches():
    from corona13_tpu_torch.ops import trace_cuda
    return {k: v for k, v in trace_cuda.launches.items() if v}


def _profile_frame(name, scene, cfg, card, frame=None, wall=None,
                   cpu_ops=True):
    """One progression (pt's, or ``frame(sample)``) under torch.profiler:
    the unprofiled wall time of the same progression (``wall`` seconds
    where the caller timed it already), the profiled device time, their
    ratio and the number of launches on the card.  cpu_ops=False traces
    the card alone (a frame of 300,000 launches parses in a fraction of
    the time)."""
    from torch.profiler import ProfilerActivity, profile
    from corona13_tpu_torch.samplers import pt as pt_mod
    frame = frame or (lambda s: pt_mod.render_sample(scene, cfg, s))
    with torch.no_grad():
        if wall is None:
            frame(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU] * cpu_ops
                     + [ProfilerActivity.CUDA]) as prof:
            frame(2)
            torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time_total for e in events) * 1e-6
    check(device_s > 0, f'{name}: the profile shows no device time')
    forms = collections.Counter()
    for e in events:
        key = _kernel_key(e.name)
        if key:
            forms[key] += e.device_time_total * 1e-3
    print(f'{name} profile: wall {wall * 1e3:.1f} ms unprofiled, device time '
          f'{device_s * 1e3:.1f} ms, busy share {device_s / wall:.2f}, '
          f'{len(events)} launches on {card}; traversal kernels (device ms): '
          + ', '.join(f'{k} {v:.3f}' for k, v in sorted(forms.items())),
          flush=True)
    return dict(wall_ms=wall * 1e3, device_ms=device_s * 1e3,
                busy_share=device_s / wall, launches=len(events),
                kernel_ms=dict(forms))


def _kernel_key(name):
    """The entry of trace_cuda.launches that a traversal kernel's name (as
    the profiler demangles it) counts under, or None for another kernel."""
    if re.search(r'union_kernel<', name):
        return 'counters'
    m = re.search(r'(traverse|deep|skip|dense)_kernel<[^<>]*?(\w+)Leaf, '
                  r'(true|false)(?:, (true|false))?', name)
    if m is None:
        return None
    kernel, leaf, any_hit, counters = m.groups()
    mode = 'any' if any_hit == 'true' else 'closest'
    kind = {'Triangle': '', 'MovingTriangle': 'moving', 'Sphere': 'sphere',
            'Cone': 'line'}[leaf]
    if kernel == 'traverse' and counters == 'true':
        return f'{kind or "tri"}_counters'
    if kernel in ('deep', 'skip'):
        return f'{kernel}_{mode}'
    if kernel == 'dense':
        return f'dense_{kind}_{mode}'
    return f'{kind}_{mode}' if kind else mode


def sky_phase(dev, card):
    import dataclasses
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.models import daylight, envmap
    from corona13_tpu_torch.samplers import pt as pt_mod
    out = {}
    phase(f'sky: envmap 1024x2048 (gradient sky, sun {SUN_DIR} at radiance '
          f'200) over the plane scene, on {card}')
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    rgb = envmap.make_gradient_sky(sun_dir=SUN_DIR, sun_radiance=200.0,
                                   res=(1024, 2048))
    torch.cuda.synchronize()
    t0 = time.time()
    sky = plane.with_envmap(rgb)
    torch.cuda.synchronize()
    out['envmap_build_s'] = time.time() - t0
    env = sky.envmap
    check(env.coeff.is_cuda and env.col_cdf.shape == (1024, 2048)
          and bool(torch.isfinite(env.coeff).all()), 'envmap tables')
    print(f'EnvMap.build (fit on the card): {out["envmap_build_s"]:.2f} s, '
          f'tables {sum(getattr(env, f.name).numel() for f in dataclasses.fields(env)) * 4 / 1e6:.1f} MB',
          flush=True)

    # sample against pdf: E[g(d)] under importance sampling equals the
    # uniform estimate of the integral of g * pdf over the sphere
    n = 1 << 22
    g = torch.Generator(device='cpu').manual_seed(21)
    r1, r2 = (torch.rand(n, generator=g).to(dev) for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    d, pdf_s = envmap.sample(env, r1, r2)
    sample_peak = torch.cuda.max_memory_allocated() / GB
    gfun = lambda x: torch.exp(x[:, 2])
    est_s = float(gfun(d).mean())
    du = torch.randn(n, 3, generator=g).to(dev)
    du = du / torch.linalg.norm(du, dim=-1, keepdim=True)
    est_u = float((gfun(du) * envmap.pdf(env, du)).mean()) * 4 * np.pi
    sun = torch.tensor(SUN_DIR, device=dev)
    sun_share = float((d @ (sun / torch.linalg.norm(sun)) > 0.995).float().mean())
    print(f'envmap.sample against envmap.pdf, {n} lanes: {est_s:.5f} sampled, '
          f'{est_u:.5f} uniform (tolerance 5%); {sun_share:.3f} of the '
          f'samples on the sun; pdf > 0 on {float((pdf_s > 0).float().mean()):.4f}; '
          f'peak memory of sample() {sample_peak:.3f} GB (an [N, W] gather of '
          f'rows would be {n * 2048 * 4 / GB:.1f} GB)', flush=True)
    check(abs(est_s - est_u) <= 0.05 * est_u, 'envmap sample and pdf disagree')
    check(sun_share > 0.1, 'envmap sampling misses the sun')
    check(sample_peak < 2.0, f'envmap.sample peaked at {sample_peak} GB')

    torch.cuda.reset_peak_memory_stats()
    res, lit, launches, rays = render_phase(
        'sky (plane under the envmap)', sky, 2, card,
        per_bounce={'any': 2})
    peak = torch.cuda.max_memory_allocated() / GB
    gather = N_RAYS * 2048 * 4 / GB
    print(f'sky frame peak memory {peak:.3f} GB (an [N, W] gather of CDF rows '
          f'alone would be {gather:.2f} GB)', flush=True)
    check(peak < gather, f'sky frame peaked at {peak} GB')
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    out['envmap'] = dict(frame_s=res.seconds / 2, rays=rays,
                         mrays_per_s=rays / res.seconds / 1e6, lit_share=lit,
                         mean=float(res.image_xyz.mean()), launches=launches,
                         peak_gb=peak,
                         profile=_profile_frame('sky frame', sky, cfg, card))
    # the same tables on both devices: the CPU fits nothing
    out['envmap']['paths_vs_cpu'] = paths_against_cpu(
        'sky paths (envmap NEE)', lambda d: dataclasses.replace(
            testing.plane_scene(device=d), envmap=_moved(env, d),
            has_envmap=True), 64, 36, dev, max_verts=6)

    day = dataclasses.replace(plane, has_daylight=True, daylight=daylight.build(
        SUN_DIR, 2.5, device=dev))
    res, lit, launches, rays = render_phase(
        'daylight (plane under daylight.build((0.3, 0.2, 0.9), 2.5))', day, 2,
        card)
    out['daylight'] = dict(frame_s=res.seconds / 2, rays=rays,
                           mrays_per_s=rays / res.seconds / 1e6,
                           lit_share=lit, mean=float(res.image_xyz.mean()),
                           paths_vs_cpu=paths_against_cpu(
        'daylight paths', lambda d: dataclasses.replace(
            testing.plane_scene(device=d), has_daylight=True,
            daylight=daylight.build(SUN_DIR, 2.5, device=d)), 64, 36, dev,
        max_verts=6))
    return out, sky


def _sync_warnings(fn):
    """Where torch reports a synchronizing call while fn runs: a dict of
    'file:line' of the Python line that made it to its count."""
    import collections
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return dict(collections.Counter(
        f'{os.path.relpath(w.filename, ROOT)}:{w.lineno}' for w in caught
        if 'synchroniz' in str(w.message)))


def compact_phase(dev, card):
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.ops import trace_cuda
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'compact: the plane scene, {W}x{H}, mf=4, max_verts=6, on {card}')
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    pix = torch.arange(N_RAYS, device=dev)
    margin = 1.25
    with torch.no_grad():
        prof = pt_mod.alive_profile(plane, cfg, 0).cpu().numpy() / N_RAYS
        caps = lambda f: (1.0,) + tuple(
            float(min(1.0, p * f)) for p in prof[1:])
        roomy, tight = cfg.replace(compact=caps(margin)), \
            cfg.replace(compact=caps(0.5))
        print(f'alive shares {", ".join(f"{p:.4f}" for p in prof)}; '
              f'capacities with a {margin} margin '
              f'{pt_mod.capacities(roomy, N_RAYS)}, at half the profile '
              f'{pt_mod.capacities(tight, N_RAYS)} lanes', flush=True)
        dense = pt_mod.render_sample(plane, cfg, 0)
        ones = pt_mod.render_sample(plane, cfg.replace(compact=(1.0,) * 5), 0)
        _zero_launches()
        # the ray counts both kernels are launched at
        sizes = {'closest_hit': [], 'any_hit': []}
        real = {k: getattr(trace_cuda, k) for k in sizes}

        def counted(name):
            def wrapper(target, kind, org, *a, **kw):
                sizes[name].append(org.shape[0])
                return real[name](target, kind, org, *a, **kw)
            return wrapper
        for k in sizes:
            setattr(trace_cuda, k, counted(k))
        try:
            room = pt_mod.render_sample(plane, roomy, 0)
        finally:
            for k in sizes:
                setattr(trace_cuda, k, real[k])
        launches = _read_launches()
        scale = float(dense.abs().max())
        err1 = float((ones - dense).abs().max()) / scale
        err2 = float((room - dense).abs().max()) / scale
        print(f'image at capacities 1.0 against dense: max |diff| {err1:.3g} '
              f'of the largest pixel; with the {margin} margin {err2:.3g} '
              f'(tolerance 1e-5); closest-hit launched at '
              f'{sizes["closest_hit"]} rays, any-hit at {sizes["any_hit"]}; '
              f'launches {launches}', flush=True)
        check(err1 <= 1e-5 and err2 <= 1e-5, 'compacted image differs')
        for k, v in sizes.items():
            check(v == pt_mod.capacities(roomy, N_RAYS),
                  f'{k} launched at {v} rays')
        check(launches == {'closest': 5, 'any': 5}, f'launches {launches}')
        a = b = 0.0
        for s in range(4):
            a = a + pt_mod.render_sample(plane, cfg, s)
            b = b + pt_mod.render_sample(plane, tight, s)
        ratio = float(b.mean() / a.mean())
        rays = {k: int(pt_mod.count_rays(plane, c, 0, pix)) for k, c in
                (('dense', cfg), ('margin', roomy), ('tight', tight))}
        print(f'energy under tight capacities over 4 progressions: '
              f'{ratio:.4f} of dense (tolerance 5%); count_rays {rays}',
              flush=True)
        check(abs(ratio - 1.0) < 0.05, f'capping lost energy: {ratio}')
        check(rays['margin'] == rays['dense'] and rays['tight'] < rays['dense'],
              f'ray counts {rays}')
        # no read-back in a progression, dense or compacted: torch's sync
        # debug mode (it counts the upload of a Python scalar too) reports
        # no synchronizing call at any line
        syncs = [_sync_warnings(lambda c=c: pt_mod.render_sample(plane, c, 1))
                 for c in (cfg, roomy)]
        print(f'synchronizing calls a progression, by line: dense '
              f'{sum(syncs[0].values())} {syncs[0]}; compacted '
              f'{sum(syncs[1].values())} {syncs[1]}', flush=True)
        check(not syncs[0] and not syncs[1],
              f'a progression synchronizes at {syncs[0]} (dense), '
              f'{syncs[1]} (compacted)')
        def frame_s(c, s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt_mod.render_sample(plane, c, s)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        times = {'dense': [], 'compacted': []}
        for r in range(4):       # in turns: dense, compacted, compacted, dense
            for k in (('dense', 'compacted') if r % 2 == 0
                      else ('compacted', 'dense')):
                times[k].append(frame_s(cfg if k == 'dense' else roomy, 10 + r))
    fmt = lambda v: (f'{np.median(v):.4f} s (min {min(v):.4f}, max '
                     f'{max(v):.4f}, {len(v)} frames)')
    print(f'frames in turns on {card}: dense {fmt(times["dense"])}; compacted '
          f'(margin {margin}) {fmt(times["compacted"])}', flush=True)
    return dict(alive=prof.tolist(), caps=pt_mod.capacities(roomy, N_RAYS),
                energy_ratio=ratio, rays=rays, dense_s=times['dense'],
                compacted_s=times['compacted'], syncs=syncs,
                profile_dense=_profile_frame('dense plane frame', plane, cfg,
                                             card),
                profile_compacted=_profile_frame('compacted plane frame',
                                                 plane, roomy, card))


def grad_phase(dev, card):
    import dataclasses
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'grad: cornell {W}x{H}, mf=4, max_verts=6, d mean(fb) / d theta by '
          f'backward() on {card}')
    scaled = lambda sc, table, leaf, t: dataclasses.replace(sc, **{
        table: dataclasses.replace(getattr(sc, table), **{
            leaf: getattr(getattr(sc, table), leaf) * t})})
    cornell = scene_mod.fit_film(testing.cornell_scene(device=dev), W, H)
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    out = {}
    # one untimed pass first: autograd's own start-up is not the frame's
    warm = torch.tensor(1.0, device=dev, requires_grad=True)
    pt_mod.render_sample(scaled(cornell, 'materials', 'e_mul', warm), cfg,
                         1).mean().backward()
    for leaf in ('e_mul', 'd_mul'):
        f = lambda t: pt_mod.render_sample(
            scaled(cornell, 'materials', leaf, t), cfg, 0).mean()
        theta = torch.tensor(1.0, device=dev, requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        value = f(theta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        value.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / GB
        g = float(theta.grad)
        eps = 1e-3
        with torch.no_grad():
            fd = (float(f(torch.tensor(1.0 + eps, device=dev)))
                  - float(f(torch.tensor(1.0 - eps, device=dev)))) / (2 * eps)
        rel = abs(g - fd) / max(abs(fd), 1e-6)
        print(f'{leaf}: backward {g:.6g}, central differences {fd:.6g}, off by '
              f'{rel:.2e} (tolerance 2e-3); forward with the graph '
              f'{t1 - t0:.3f} s, backward {t2 - t1:.3f} s, peak memory '
              f'{peak:.2f} GB in one piece (no pixel ranges); kernel '
              f'launches {launches}', flush=True)
        check(np.isfinite(g) and g != 0 and rel <= 2e-3,
              f'{leaf}: gradient {g} against central differences {fd}')
        check(launches == {k: 5 for k in ('closest', 'any',
                                          'dense_sphere_closest',
                                          'dense_sphere_any')},
              f'gradient frame launches {launches}')
        out[leaf] = dict(grad=g, fd=fd, forward_s=t1 - t0, backward_s=t2 - t1,
                         peak_gb=peak)

    # the nonlinear parameters of tests/test_grad.py:96-118 at its sizes
    small = pt_mod.PTConfig(width=16, height=12, max_verts=4, mf=2)
    media = small.replace(max_verts=8, media=True)
    off = torch.tensor([0.3, 0.2, 0.5], device=dev)
    cases = [
        ('roughness', 'metal', small, lambda s, t: scaled(s, 'materials', 'roughness', t)),
        ('ior_nd', 'dielectric', small, lambda s, t: scaled(s, 'materials', 'ior_nd', t)),
        ('med_mut_mul', 'subsurf', media, lambda s, t: scaled(s, 'materials', 'med_mut_mul', t)),
        ('med_g', 'subsurf', media, lambda s, t: scaled(s, 'materials', 'med_g', t)),
        ('focus', 'diffuse', small, lambda s, t: scaled(s, 'camera', 'focus', t)),
        ('cam_pos', 'diffuse', small, lambda s, t: dataclasses.replace(
            s, camera=dataclasses.replace(
                s.camera, pos=s.camera.pos + (t - 1.0) * off.to(t.device)))),
        # the two linear ones again, small, for the card against the CPU
        ('e_mul', 'diffuse', small.replace(width=64, height=36, max_verts=6, mf=4),
         lambda s, t: scaled(s, 'materials', 'e_mul', t)),
        ('d_mul', 'diffuse', small.replace(width=64, height=36, max_verts=6, mf=4),
         lambda s, t: scaled(s, 'materials', 'd_mul', t)),
    ]
    grads = {}
    for name, sphere, c, apply in cases:
        pair = []
        for d in (dev, torch.device('cpu')):
            sc = scene_mod.fit_film(testing.cornell_scene(sphere=sphere,
                                                          device=d),
                                    c.width, c.height)
            theta = torch.tensor(1.0, device=d, requires_grad=True)
            pt_mod.render_sample(apply(sc, theta), c, 0).mean().backward()
            pair.append(float(theta.grad))
        grads[name] = pair
        check(np.isfinite(pair[0]), f'{name}: gradient {pair[0]} on the card')
    print('gradients card / CPU: ' + ', '.join(
        f'{k} {v[0]:.6g} / {v[1]:.6g}' for k, v in grads.items()), flush=True)
    check(grads['ior_nd'][0] != 0.0, 'the ior_nd gradient is zero')
    for k in ('e_mul', 'd_mul'):
        card_g, cpu_g = grads[k]
        check(abs(card_g - cpu_g) <= 5e-3 * abs(cpu_g),
              f'{k}: card {card_g} against CPU {cpu_g} at 64x36 (5e-3)')
    out['card_vs_cpu'] = grads
    return out


def _dbor_cascade(sky, dev, card, spp=2):
    """The DBOR cascade on a frame whose luminance spans its levels (the
    plane under the sun envmap, exposed so that the median lit sample has
    luminance 16, the middle of the cascade): the levels filled, their sum
    against the plain splat, the CLI's loop against these samples, and the
    card's cascade and merge against the CPU's on the same samples."""
    import dataclasses
    from corona13_tpu_torch import __main__ as cli
    from corona13_tpu_torch.ops import splat as splat_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    from corona13_tpu_torch.spectral import cie
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    pix = torch.arange(N_RAYS, device=dev)
    cpu = torch.device('cpu')
    fbs = {d: torch.zeros((splat_mod.N_DBOR, H, W, 3), device=d)
           for d in (dev, cpu)}
    plain = torch.zeros((H, W, 3), device=dev)
    with torch.no_grad():
        accum, lam, _, _ = pt_mod.sample_paths(sky, cfg, 0, pix)
        lum = cie.spectral_to_xyz(lam, pt_mod._finite(accum))[:, 1]
        gain = 16.0 / float(lum[lum > 0].median())
        sky = dataclasses.replace(sky, camera=dataclasses.replace(
            sky.camera, exposure_time=sky.camera.exposure_time * gain))
        for s in range(spp):
            accum, lam, pi, pj = pt_mod.sample_paths(sky, cfg, s, pix)
            xyz = cie.spectral_to_xyz(lam, pt_mod._finite(accum))
            plain = splat_mod.splat(plain, pi, pj, xyz, 'box')
            for d in fbs:
                fbs[d] = splat_mod.splat_dbor(fbs[d], pi.to(d), pj.to(d),
                                              xyz.to(d))
        looped = cli._render_dbor(sky, cfg, 0, spp)
        merged = {d: splat_mod.dbor_merge(fbs[d]) for d in fbs}
    card_fbs, top = fbs[dev], float(plain.abs().max())
    filled = [float((card_fbs[k][..., 1] > 0).float().mean())
              for k in range(splat_mod.N_DBOR)]
    sum_err = float((card_fbs.sum(0) - plain).abs().max()) / top
    loop_err = float((looped - card_fbs).abs().max()) / top
    lev_err = float((card_fbs.cpu() - fbs[cpu]).abs().max()) / top
    mtop = float(merged[cpu].abs().max())
    merge_err = float((merged[dev].cpu() - merged[cpu]).abs().max()) / mtop
    kept = float(merged[dev].sum() / plain.sum())
    print(f'dbor cascade on the sky frame exposed {gain:.4g} times, {spp} '
          f'progressions of {W}x{H} on {card}: share of pixels filled by level '
          f'{", ".join(f"{x:.4f}" for x in filled)}; sum of the levels against '
          f'the plain splat {sum_err:.2e} of the largest pixel (tolerance '
          f'1e-4); the CLI loop against these samples {loop_err:.2e} (1e-6); '
          f'levels card against CPU {lev_err:.2e}, merged {merge_err:.2e} '
          f'(1e-5); the merge keeps {kept:.4f} of the energy', flush=True)
    check(sum(x > 0 for x in filled[1:]) >= 2,
          f'the frame fills fewer than two levels above 0: {filled}')
    check(sum_err <= 1e-4, f'the levels do not add up to the splat: {sum_err}')
    check(loop_err <= 1e-6, f'the CLI loop differs: {loop_err}')
    check(lev_err <= 1e-5 and merge_err <= 1e-5,
          f'cascade on the card against the CPU: {lev_err}, {merge_err}')
    check(bool(torch.isfinite(merged[dev]).all()) and 0 < kept <= 1.0 + 1e-5,
          f'the merge keeps {kept} of the energy')
    return dict(gain=gain, filled=filled, sum_err=sum_err, loop_err=loop_err,
                levels_vs_cpu=lev_err, merged_vs_cpu=merge_err, kept=kept)


def dbor_vis_phase(dev, sky, card):
    """--dbor and --sampler vis through the CLI on 0002_mb, the plain
    render for the comparison through render.render in this process; every
    luminance of that scene lies below 1, in level 0, so the cascade itself
    is held on the sky frame."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.io import pfm as pfm_io
    from corona13_tpu_torch.ops import splat as splat_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase('CLI: python -m corona13_tpu_torch 0002_mb --dbor, and --sampler vis')
    size = ['-w', '256', '-h', '160']
    with tempfile.TemporaryDirectory() as tmp:
        def run(*args):
            p = subprocess.run(
                [sys.executable, '-m', 'corona13_tpu_torch', 'data/golden/'
                 'scenes/0002_mb/test.nra2', *size, *args], cwd=ROOT,
                capture_output=True, text=True, timeout=600)
            print(p.stdout.strip().splitlines()[-1], flush=True)
            check(p.returncode == 0,
                  f'CLI {args} exited {p.returncode}: {p.stderr[-2000:]}')
        out = os.path.join(tmp, 'dbor')
        run('-s', '4', '--max-verts', '6', '--dbor', '-x', out)
        levels = [pfm_io.read_pfm(f'{out}_dbor{k:02d}.pfm')
                  for k in range(splat_mod.N_DBOR)]
        merged = pfm_io.read_pfm(out + '_fb00.pfm')
        vis = os.path.join(tmp, 'vis')
        run('--sampler', 'vis', '--aov', 'normals', '-x', vis)
        normals = pfm_io.read_pfm(vis + '_fb00.pfm')
    sc, _ = scene_mod.load_scene(_scene_path('0002_mb'), device=dev)
    sc = scene_mod.fit_film(sc, 256, 160)
    plain = render_mod.render(sc, pt_mod.PTConfig(
        width=256, height=160, max_verts=6, mf=4), spp=4, batch=1).image_xyz
    off = abs(merged.mean() - plain.mean()) / plain.mean()
    print(f'dbor: {len(levels)} cascade files, level means '
          f'{", ".join(f"{l.mean():.3g}" for l in levels)}; merged mean '
          f'{merged.mean():.6g} against the plain render {plain.mean():.6g}, '
          f'off by {off:.4f} (tolerance 5%); normals AOV {normals.shape}, '
          f'mean {normals.mean():.4f}', flush=True)
    check(all(l.shape == (160, 256, 3) and np.isfinite(l).all()
              for l in levels), 'dbor cascade files')
    check(np.isfinite(merged).all() and off < 0.05, f'dbor merged off by {off}')
    check(normals.shape == (160, 256, 3) and np.isfinite(normals).all()
          and 0 < normals.max() <= 1.0, 'normals AOV')
    return dict(merged_off=float(off), normals_mean=float(normals.mean()),
                cascade=_dbor_cascade(sky, dev, card))


# --- phase 15: the light-path samplers ---------------------------------------

# traversal calls (closest, any) a progression at max_verts=6: lt traces
# 4 bounces and connects the light vertex and each bounce to the camera;
# bdpt traces 5 eye and 3 light bounces, and each connection with a light
# vertex (s >= 1: 10 with t >= 2, 4 camera splats) is one any-hit call;
# ptlt keeps s = 1 (4) and the camera splats (4); bdpt1 connects once, an
# any-hit call only where its pick has s >= 1
LIGHT_CALLS = {'lt': (4, 5), 'bdpt': (8, 14), 'ptlt': (8, 8)}
LIGHT_SAMPLERS = ('lt', 'bdpt', 'ptlt', 'bdpt1')


def _light_frame(name, scene, cfg):
    """frame(sample) of one light-path sampler, and the picks of bdpt1
    (the strategy of each progression, appended as it renders)."""
    from corona13_tpu_torch.samplers import bdpt, bdpt1, lt, ptlt
    if name != 'bdpt1':
        render = {'lt': lt.render_sample, 'bdpt': bdpt.render_sample,
                  'ptlt': ptlt.render_sample}[name]
        return lambda s: render(scene, cfg, s), None
    table, picks = bdpt1.ConfigTable.create(cfg), []

    def frame(s):
        picks.append(table.strategies[bdpt1.pick(cfg, s, table)[0]])
        return bdpt1.render_sample(scene, cfg, s, table)[0]
    return frame, picks


def _rays_traced(frame, s):
    """Rays one progression traces: lanes with t_max > 0 in the triangle
    kernel's calls (each call launches it once, before any other kind)."""
    from corona13_tpu_torch.ops import trace_cuda
    count = [0]
    real = {k: getattr(trace_cuda, k) for k in ('closest_hit', 'any_hit')}

    def counted(name):
        def wrapper(target, kind, org, direction, t_max, *a, **kw):
            if kind in ('tri', 'moving'):
                count[0] += int((torch.as_tensor(t_max) > 0).sum()) \
                    if torch.is_tensor(t_max) else org.shape[0]
            return real[name](target, kind, org, direction, t_max, *a, **kw)
        return wrapper
    for k in real:
        setattr(trace_cuda, k, counted(k))
    try:
        frame(s)
    finally:
        for k, f in real.items():
            setattr(trace_cuda, k, f)
    return count[0]


def _light_frames(name, label, scene, cfg, card, dense, warm=2, timed=3):
    """warm untimed progressions, then timed ones, each ending on the host,
    with the launch counts zeroed just before the timed ones and read just
    after (held to LIGHT_CALLS a progression; each call on cornell also
    launches the dense sphere form); peak device memory over the timed
    ones; the rays of one more progression."""
    frame, picks = _light_frame(name, scene, cfg)
    times = []
    with torch.no_grad():
        for s in range(warm):
            frame(s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        for s in range(warm, warm + timed):
            t0 = time.perf_counter()
            img = frame(s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / GB
        rays = _rays_traced(frame, warm + timed)
    if picks is not None:
        per = [(8, int(st[0] >= 1)) for st in picks[warm:warm + timed]]
    else:
        per = [LIGHT_CALLS[name]] * timed
    calls = {'closest': sum(c for c, _ in per), 'any': sum(a for _, a in per)}
    if dense:
        calls.update({'dense_sphere_' + k: v for k, v in list(calls.items())})
    expect = {k: v for k, v in calls.items() if v}
    med = float(np.median(times))
    img = img.cpu().numpy()
    print(f'{label}: {med:.4f} s per frame (min {min(times):.4f}, max '
          f'{max(times):.4f}, {timed} frames after {warm} warm-up); kernel '
          f'launches {launches} over the {timed} frames (expected {expect}'
          f'{", picks " + str(picks[warm:warm + timed]) if picks else ""}); '
          f'{rays} rays a frame, {rays / med / 1e6:.2f} Mrays/s; peak memory '
          f'{peak:.3f} GB; image mean {img.mean():.6g}, finite '
          f'{bool(np.isfinite(img).all())} on {card}', flush=True)
    check(launches == expect, f'{label}: launches {launches}, expected {expect}')
    check(np.isfinite(img).all() and img.mean() > 0, f'{label}: image')
    return dict(frame_s=times, median_s=med, launches=launches,
                launches_per_frame={k: v / timed for k, v in launches.items()},
                rays=rays, mrays_per_s=rays / med / 1e6, peak_gb=peak,
                mean=float(img.mean()), picks=picks)


def _splat_times():
    """scripts/splat_times.py of this checkout (its capture of bdpt's
    camera splats, its timer and the index_add scatter)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'splat_times', os.path.join(ROOT, 'scripts', 'splat_times.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _light_splats(scene, cfg, dev, card):
    """The four t = 1 splats of one bdpt progression (their inputs
    captured as bdpt hands them to splat): into one framebuffer twice,
    bit-identical; against the CPU on the same inputs; splat's wall and
    device time a call at that width beside the index_add scatter it
    replaced, and that scatter's own run-to-run difference."""
    from corona13_tpu_torch.ops import splat as splat_mod
    st = _splat_times()
    calls = st.capture(scene, cfg)
    check(len(calls) == 4, f'{len(calls)} general splats in a bdpt frame')

    def four(d, scatter=None):
        fb = torch.zeros((H, W, 3), device=d)
        own = splat_mod._scatter
        splat_mod._scatter = scatter or own
        try:
            for pi, pj, col in calls:
                fb = splat_mod.splat(fb, pi.to(d), pj.to(d), col.to(d))
        finally:
            splat_mod._scatter = own
        return fb
    a, b = four(dev), four(dev)
    cpu = four(torch.device('cpu'))
    top = float(cpu.abs().max())
    err = float((a.cpu() - cpu).abs().max()) / top
    old = [four(dev, st.scatter_index_add) for _ in range(2)]
    old_diff = float((old[0] - old[1]).abs().max()) / top
    old_bits = int((old[0].view(torch.int32) != old[1].view(torch.int32)).sum())
    fb0 = torch.zeros((H, W, 3), device=dev)
    run = lambda i: splat_mod.splat(fb0, *calls[i % 4])
    new = st.time_calls(run)
    own = splat_mod._scatter
    splat_mod._scatter = st.scatter_index_add
    try:
        ref = st.time_calls(run)
    finally:
        splat_mod._scatter = own
    n = calls[0][0].shape[0]
    print(f'general splat, the 4 t = 1 splats of a bdpt frame ({n} splats x '
          f'16 taps x 3 colours each): two runs bit-identical '
          f'{torch.equal(a, b)}; card against CPU {err:.2e} of the largest '
          f'pixel (tolerance 1e-6); splat (sorted segmented sum) '
          f'{new["wall_ms"]:.3f} ms a call, device {new["device_ms"]:.3f} ms, '
          f'{new["launches"]:.0f} launches; with index_add '
          f'{ref["wall_ms"]:.3f} ms, device {ref["device_ms"]:.3f} ms, '
          f'{ref["launches"]:.0f} launches, its two runs differing on '
          f'{old_bits} of {a.numel()} values by up to {old_diff:.2e} of the '
          f'largest pixel; on {card}', flush=True)
    check(torch.equal(a, b), 'the splat is not reproducible on the card')
    check(err <= 1e-6, f'splat on the card against the CPU: {err}')
    check(new['device_ms'] > 0, 'the splat profile shows no device time')
    return dict(splats=n, bit_identical=True, vs_cpu=err, ms=new['wall_ms'],
                device_ms=new['device_ms'], launches=new['launches'],
                index_add_ms=ref['wall_ms'],
                index_add_device_ms=ref['device_ms'],
                index_add_launches=ref['launches'],
                index_add_bits_differing=old_bits,
                index_add_run_diff=old_diff)


def _light_vs_cpu(dev, w=64, h=36):
    """lt, bdpt and ptlt on the card against the CPU on the same scene and
    sample index (each pixel within 1e-4 of the largest on >= 99% of
    pixels); bdpt1's picks and table over 4 progressions on both."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import bdpt1
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'light paths on the card against the CPU, cornell {w}x{h}')
    cfg = pt_mod.PTConfig(width=w, height=h, max_verts=6, mf=4, use_nee=True)
    scenes = {i: scene_mod.fit_film(testing.cornell_scene(device=d), w, h)
              for i, d in enumerate((dev, torch.device('cpu')))}
    out = {}
    with torch.no_grad():
        for name in ('lt', 'bdpt', 'ptlt'):
            img = [_light_frame(name, sc, cfg)[0](5).cpu().numpy()
                   for sc in scenes.values()]
            top = float(np.abs(img[1]).max())
            share = float(np.isclose(img[0], img[1], rtol=0, atol=1e-4 * top)
                          .all(axis=-1).mean())
            print(f'{name}: pixels within 1e-4 of the largest {share:.4f} '
                  f'(bar 0.99), means {img[0].mean():.6g} vs '
                  f'{img[1].mean():.6g}', flush=True)
            check(top > 0 and share >= 0.99, f'{name} card against CPU {share}')
            out[name] = share
        tables = []
        for sc in scenes.values():
            t = bdpt1.ConfigTable.create(cfg)
            picks = []
            for s in range(4):
                picks.append(bdpt1.pick(cfg, s, t)[0])
                bdpt1.render_sample(sc, cfg, s, t)
            tables.append((picks, t))
    (pc, tc), (ph, th) = tables
    rel = float(np.max(np.abs(tc.mean - th.mean) / np.abs(th.mean)))
    print(f'bdpt1 over 4 progressions: picks {pc} on the card, {ph} on the '
          f'CPU; counts equal {bool((tc.count == th.count).all())}; means '
          f'{rel:.2e} apart (tolerance 1e-4)', flush=True)
    check(pc == ph and (tc.count == th.count).all() and rel <= 1e-4,
          'bdpt1 table on the card differs from the CPU')
    out['bdpt1'] = dict(picks=pc, mean_rel=rel)
    return out


def _light_cli():
    """python -m corona13_tpu_torch 0002_mb --sampler S, the four at once."""
    from corona13_tpu_torch.io import pfm as pfm_io
    phase('CLI: python -m corona13_tpu_torch 0002_mb --sampler '
          'lt|bdpt|ptlt|bdpt1 -s 2 -w 256 -h 160')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {s: subprocess.Popen(
            [sys.executable, '-m', 'corona13_tpu_torch',
             'data/golden/scenes/0002_mb/test.nra2', '--sampler', s, '-s', '2',
             '-w', '256', '-h', '160', '-x', os.path.join(tmp, s)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s in LIGHT_SAMPLERS}
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            check(p.returncode == 0,
                  f'CLI --sampler {s} exited {p.returncode}: {stderr[-2000:]}')
            img = pfm_io.read_pfm(os.path.join(tmp, s + '_fb00.pfm'))
            frame = [l for l in stdout.splitlines() if 's/frame' in l][-1]
            print(f'--sampler {s}: {frame.strip()}, image {img.shape}, mean '
                  f'{img.mean():.6g}', flush=True)
            check(img.shape == (160, 256, 3) and np.isfinite(img).all()
                  and img.mean() > 0, f'CLI --sampler {s}: image')
            out[s] = float(img.mean())
    return out


def light_paths_phase(dev, card):
    """lt, bdpt, ptlt and bdpt1 on cornell at full width, bdpt on the plane
    scene, the general splat of bdpt's camera splats, the card against the
    CPU, and the CLI."""
    import collections
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import bdpt
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    phase(f'light paths: lt, bdpt, ptlt, bdpt1 on cornell {W}x{H}, mf=4, '
          f'max_verts=6, on {card}')
    cornell = scene_mod.fit_film(testing.cornell_scene(device=dev), W, H)
    out = {name: _light_frames(name, name, cornell, cfg, card, dense=True)
           for name in LIGHT_SAMPLERS}
    out['bdpt_profile'] = _profile_frame(
        'bdpt frame', cornell, cfg, card,
        frame=lambda s: bdpt.render_sample(cornell, cfg, s))
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    out['bdpt_plane'] = _light_frames(
        'bdpt', f'bdpt on the plane scene ({plane.geom.n_tris} triangles)',
        plane, cfg, card, dense=False, warm=1, timed=1)
    out['splat'] = _light_splats(cornell, cfg, dev, card)
    out['vs_cpu'] = _light_vs_cpu(dev)
    out['cli'] = _light_cli()
    total = collections.Counter()
    for k in LIGHT_SAMPLERS + ('bdpt_plane',):
        total.update(out[k]['launches'])
    out['launches'] = dict(total)
    return out


# --- phase 16: ppm and the MLT samplers -------------------------------------

MLT_SAMPLERS = ('ppm', 'kmlt', 'vmlt')


def _mlt_module(name):
    from corona13_tpu_torch.samplers import kmlt, ppm, vmlt
    return {'ppm': ppm, 'kmlt': kmlt, 'vmlt': vmlt}[name]


def _mlt_calls(name, cfg, chains=8192, burn_in=8):
    """(closest, any) traversal calls of one progression: ppm traces
    max(max_verts - 1, 2) photon bounces and min(max_verts - 1, 4) eye
    bounces, closest-hit only; kmlt and vmlt replay pt (one closest-hit
    and one any-hit call a bounce) on the seeding pool and at each of
    burn_in + n_mut mutations."""
    if name == 'ppm':
        return max(cfg.max_verts - 1, 2) + min(cfg.max_verts - 1, 4), 0
    replays = 1 + max(1, cfg.width * cfg.height // chains) + burn_in
    return (cfg.max_verts - 1) * replays, (cfg.max_verts - 1) * replays


def _mlt_frames(name, scene, cfg, card, warm, timed):
    """warm untimed progressions, then timed ones ending on the host, the
    launch counts zeroed just before the timed ones and read just after
    (held to _mlt_calls; cornell's dense sphere form launches with each
    call), peak device memory over the timed ones."""
    render = _mlt_module(name).render_sample
    times = []
    with torch.no_grad():
        for s in range(warm):
            render(scene, cfg, s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        for s in range(warm, warm + timed):
            t0 = time.perf_counter()
            img = render(scene, cfg, s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / GB
    c, a = _mlt_calls(name, cfg)
    expect = {k: v * timed for k, v in (('closest', c), ('any', a),
                                        ('dense_sphere_closest', c),
                                        ('dense_sphere_any', a)) if v}
    med = float(np.median(times))
    img = img.cpu().numpy()
    print(f'{name}: {med:.4f} s per frame (min {min(times):.4f}, max '
          f'{max(times):.4f}, {timed} frames after {warm} warm-up); kernel '
          f'launches {launches} over the {timed} frames (expected {expect}); '
          f'peak memory {peak:.3f} GB; image mean {img.mean():.6g}, finite '
          f'{bool(np.isfinite(img).all())} on {card}', flush=True)
    check(launches == expect, f'{name}: launches {launches}, expected {expect}')
    check(np.isfinite(img).all() and img.mean() > 0, f'{name}: image')
    return dict(frame_s=times, median_s=med, launches=launches,
                launches_per_frame={k: v / timed for k, v in launches.items()},
                peak_gb=peak, mean=float(img.mean()))


def _mlt_step_syncs(name, scene, cfg):
    """Synchronizing calls in one mutation step after burn-in (both
    splats included) at 8192 chains, by _sync_warnings."""
    from corona13_tpu_torch.samplers import kmlt
    mod = _mlt_module(name)
    with torch.no_grad():
        carry = kmlt.init_chains(scene, cfg, 0, 8192, mod.MULT)
        syncs = _sync_warnings(lambda: mod.step(scene, cfg, carry, 9))
    print(f'{name}: synchronizing calls in one mutation step: {syncs or 0}',
          flush=True)
    check(not syncs, f'{name} mutation step synchronizes: {syncs}')
    return sum(syncs.values())


def _cloned(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(y) for y in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


def _capture_calls(fn, n_lanes, picks):
    """Run fn with trace_cuda.closest_hit and any_hit wrapped.  A call of
    trace.intersect / occluded launches one form per prim kind, the first
    without a carry; for the picks[mode]-th such call on n_lanes rays
    (0-based; a collection of indices keeps each of them), keep each
    launch's arguments as the form was given them (the carry cloned before
    the launch updates it in place), in the order of the launches."""
    from corona13_tpu_torch.ops import trace_cuda
    real = {m: getattr(trace_cuda, m) for m in picks}
    want = {m: {p} if isinstance(p, int) else set(p)
            for m, p in picks.items()}
    seen = {m: -1 for m in picks}
    kept = {m: [] for m in picks}

    def wrapped(mode):
        def call(target, kind, org, *a, **kw):
            if org.shape[0] == n_lanes:
                seen[mode] += kw.get('carry') is None
                if seen[mode] in want[mode]:
                    kept[mode].append((target, kind, _cloned((org,) + a),
                                       _cloned(kw)))
            return real[mode](target, kind, org, *a, **kw)
        return call
    for m in picks:
        setattr(trace_cuda, m, wrapped(m))
    try:
        with torch.no_grad():
            fn()
    finally:
        for m, f in real.items():
            setattr(trace_cuda, m, f)
    return kept


def _hold_launch(where, mode, target, kind, args, kw):
    """One captured launch again on the card, twice (bit-identical), and by
    its plain version on the same tensors (timed; a tree's with the
    skip-link walk's counts, _plain_counts): prim, slot and t, u, v (the
    any-hit flag) held as phase 3b holds them (_form_compare).  Returns the
    launch's record: its key in trace_cuda.launches, form, rays, alive,
    agreement, max |dt|, plain ms and the walk's summed counts."""
    from corona13_tpu_torch.ops import trace_cuda
    any_hit = mode == 'any_hit'
    form = trace_cuda._form_of(target, kind)
    key = trace_cuda._count_key(form, kind, any_hit)
    kern = lambda: getattr(trace_cuda, mode)(target, kind, *args,
                                             **_cloned(kw))
    k, k2 = kern(), kern()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p, *counts = _plain_counts(form, kind,
                               getattr(trace_cuda, mode + '_plain'),
                               target, kind, *args, **_cloned(kw))
    end.record()
    torch.cuda.synchronize()
    visits, leafs, missed = map(_total, counts)
    same = all(torch.equal(_bits(x), _bits(y)) for x, y in zip(
        (k,) if any_hit else k, (k2,) if any_hit else k2))
    agree, slot, err = _form_compare(k, p, any_hit, f'{where} {key}',
                                     _exact(form, kind))
    t, n = args[2], args[0].shape[0]
    alive = int((t > 0).sum()) if torch.is_tensor(t) else n
    print(f'  {where:34s} {key:22s} {n} rays, alive {alive}: '
          + (f'blocked agree {agree:.6f}' if any_hit else
             f'prim agree {agree:.6f}, slot agree {slot:.6f}, max '
             f'|dt| {err:.3g}') + f', two launches identical {same}',
          flush=True)
    check(same, f'{where} {key}: two launches differ')
    return dict(key=key, form=form, rays=n, alive=alive, agree=agree,
                slot_agree=slot, max_abs_err=err,
                plain_ms=start.elapsed_time(end), visits=visits, leafs=leafs,
                missed=missed)


def _hold_calls(where, kept):
    """Each captured launch held by _hold_launch; per form, the least
    agreement and the largest max |dt| over its launches."""
    out = {}
    for mode, calls in kept.items():
        check(calls, f'{where}: no {mode} call captured')
        for target, kind, args, kw in calls:
            r = _hold_launch(where, mode, target, kind, args, kw)
            o = out.setdefault(r['key'], dict(
                rays=r['rays'], alive=r['alive'], agree=1.0, slot_agree=1.0,
                max_abs_err=0.0))
            o['agree'] = min(o['agree'], r['agree'])
            o['slot_agree'] = min(o['slot_agree'], r['slot_agree'])
            o['max_abs_err'] = max(o['max_abs_err'], r['max_abs_err'])
    return out


def frame_calls(scene, cfg, sample=0):
    """Every trace_cuda launch of one pt progression (render_sample) at the
    frame's full width, as _capture_calls keeps them: {'closest_hit':
    [...], 'any_hit': [...]} in the order of the launches."""
    from corona13_tpu_torch.samplers import pt as pt_mod
    n = cfg.width * cfg.height
    every = range(2 * cfg.max_verts)   # at most two calls of a mode a bounce
    return _capture_calls(lambda: pt_mod.render_sample(scene, cfg, sample), n,
                          {'closest_hit': every, 'any_hit': every})


def frame_forms(where, kept, keys, card, reps=20):
    """The captured launches of the forms in ``keys`` (entries of
    trace_cuda.launches) at a frame's own shapes: each held by _hold_launch,
    timed on the card (the spin timer, mean of ``reps`` launches, every
    launch on a fresh clone of its carry) and given the bound _form_bound
    gives phase 3b, from the plain skip-link walk's visits on the same rays
    (for the line form also the bound with its early exit at the
    discriminant).  Returns per form: the launches a frame, the frame's sum
    of kernel ms, of bound ms and of plain ms, the mean per launch, and the
    launches in order."""
    from corona13_tpu_torch.ops import trace_cuda
    out = {}
    for mode, calls in kept.items():
        any_hit = mode == 'any_hit'
        tup = (lambda x: (x,)) if any_hit else (lambda x: x)
        kern = getattr(trace_cuda, mode)
        for target, kind, args, kw in calls:
            key = trace_cuda._count_key(trace_cuda._form_of(target, kind),
                                        kind, any_hit)
            if key not in keys:
                continue
            r = _hold_launch(where, mode, target, kind, args, kw)
            pool = []

            def fresh():
                pool[:] = [_cloned(kw) for _ in range(reps)]
            ms = _time_ms(lambda i: tup(kern(target, kind, *args, **pool[i])),
                          reps, reps, before=fresh)
            static_ms = None
            if kind == 'moving':
                # the yardstick: the static walk (TriangleLeaf) of the same
                # tree on the same rays, shutter-open rows and no time
                static_ms = _time_ms(lambda i: tup(kern(
                    target, 'tri', *args, **dict(pool[i], time=None))),
                    reps, reps, before=fresh)
            pool.clear()
            n, nv, nl = r['rays'], r['visits'], r['leafs']
            bound, by = _form_bound(target, kind, r['form'], n, r['alive'],
                                    1 if any_hit else 28, nv, nl)
            missed = r['missed'] if kind == 'line' else None
            exit_bound = None if missed is None else _form_bound(
                target, kind, r['form'], n, r['alive'], 1 if any_hit else 28,
                nv, nl, missed)[0]
            rec = out.setdefault(key, dict(launches=0, ms=0.0, bound_ms=0.0,
                                           plain_ms=0.0, agree=1.0,
                                           max_abs_err=0.0, calls=[]))
            rec['launches'] += 1
            rec['ms'] += ms
            if static_ms is not None:
                rec['static_ms'] = rec.get('static_ms', 0.0) + static_ms
                rec['leaf_pop_bytes'] = leaf_pop_bytes(target)
            rec['bound_ms'] += bound
            rec['plain_ms'] += r['plain_ms']
            if exit_bound is not None:
                rec['exit_bound_ms'] = rec.get('exit_bound_ms', 0.0) + \
                    exit_bound
            rec['agree'] = min(rec['agree'], r['agree'], r['slot_agree'])
            rec['max_abs_err'] = max(rec['max_abs_err'], r['max_abs_err'])
            rec['calls'].append(dict(
                rays=n, alive=r['alive'], ms=ms, bound_ms=bound, bound_by=by,
                exit_bound_ms=exit_bound, plain_ms=r['plain_ms'],
                agree=r['agree'], slot_agree=r['slot_agree'],
                max_abs_err=r['max_abs_err'], nodes_per_ray=nv / n,
                leaves_per_ray=nl / n,
                missed_rows_per_ray=None if missed is None else missed / n,
                static_ms=static_ms))
            print(f'  {where:10s} {key:13s} launch {rec["launches"]}: {n} '
                  f'rays, alive {r["alive"]}; kernel {ms:.4f} ms'
                  + ('' if static_ms is None else
                     f' (static walk of the same tree {static_ms:.4f} ms)')
                  + f', bound '
                  f'{bound:.4f} ms by {by} (share {bound / ms:.3f}), plain '
                  f'{r["plain_ms"]:.1f} ms; skip-link walk {nv / n:.2f} '
                  f'nodes / {nl / n:.2f} leaves a ray'
                  + ('' if exit_bound is None else
                     f'; {missed / n:.2f} rows a ray missed at the '
                     f'discriminant, bound with the early exit '
                     f'{exit_bound:.4f} ms (share {exit_bound / ms:.3f})'),
                  flush=True)
    for key, rec in out.items():
        rec['ms_per_launch'] = rec['ms'] / rec['launches']
        rec['bound_ms_per_launch'] = rec['bound_ms'] / rec['launches']
        rec['roofline_share'] = rec['bound_ms'] / rec['ms']
        rec['loss_ms'] = rec['ms'] - rec['bound_ms']
        if 'exit_bound_ms' in rec:
            rec['exit_roofline_share'] = rec['exit_bound_ms'] / rec['ms']
        if 'static_ms' in rec:
            rec['static_ms_per_launch'] = rec['static_ms'] / rec['launches']
            before, now = rec['leaf_pop_bytes']
            print(f'  {where:10s} {key:13s} record bytes a leaf pop: before '
                  f'{before} B (8 rows, two records each), now '
                  + ('not in this tree' if now is None else
                     f'{now:.1f} B (filled rows, a second record where a '
                     f'row moves), mean over the leaves'), flush=True)
        print(f'  {where:10s} {key:13s} a frame: {rec["launches"]} launches, '
              f'kernel {rec["ms"]:.4f} ms'
              + ('' if 'static_ms' not in rec else
                 f' (static walk of the same tree on the same rays '
                 f'{rec["static_ms"]:.4f} ms)')
              + f', bound {rec["bound_ms"]:.4f} ms '
              f'(share {rec["roofline_share"]:.3f}), launches x (time - '
              f'bound) {rec["loss_ms"]:.4f} ms, plain {rec["plain_ms"]:.1f} '
              f'ms'
              + (f', bound with the early exit {rec["exit_bound_ms"]:.4f} ms '
                 f'(share {rec["exit_roofline_share"]:.3f})'
                 if 'exit_bound_ms' in rec else '') + f', on {card}',
              flush=True)
    return out


def _kernels_at_mlt_shapes(scene, cfg):
    """The traversal forms at the shapes ppm, kmlt and vmlt give them,
    captured from the samplers' own calls: the second photon bounce of
    ppm's photon pass (2 * W * H rays, ignore ids from the first hit, lanes
    dead where the path ended) and the second bounce and second NEE shadow
    batch of one kmlt and one vmlt mutation step (8192 rays), each form's
    kernel against its plain version on the same tensors."""
    from corona13_tpu_torch.samplers import kmlt, ppm
    phase(f'the traversal forms against plain at the ppm and MLT shapes, '
          f'cornell {W}x{H}')
    n_paths = 2 * W * H
    out = {'ppm photon bounce': _hold_calls('ppm photon bounce', _capture_calls(
        lambda: ppm.photon_pass(scene, cfg, 0, n_paths,
                                max(cfg.max_verts - 1, 2)),
        n_paths, {'closest_hit': 1}))}
    for name in ('kmlt', 'vmlt'):
        mod = _mlt_module(name)
        with torch.no_grad():
            carry = kmlt.init_chains(scene, cfg, 0, 8192, mod.MULT)
        out[f'{name} replay bounce'] = _hold_calls(
            f'{name} replay bounce', _capture_calls(
                lambda: mod.step(scene, cfg, carry, 9), 8192,
                {'closest_hit': 1, 'any_hit': 1}))
    print('tolerance: prim and slot (any-hit: blocked) identical on >= 99.9% '
          'of rays, t rel 1e-6 and u, v 1e-6 where prim agrees; two launches '
          'bit-identical', flush=True)
    return out


def _mlt_vs_cpu(dev, w=64, h=36, chains=256):
    """ppm, kmlt and vmlt (chains=256) on the card against the CPU on the
    same scene and sample index: the share of pixels within 1e-4 of the
    largest (bar 0.99); for the chains, where an accept flips on an ulp,
    >= 99% of the chains in the same final state and the means within
    1e-3 instead."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import kmlt
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'ppm, kmlt, vmlt on the card against the CPU, cornell {w}x{h}, '
          f'chains={chains}')
    cfg = pt_mod.PTConfig(width=w, height=h, max_verts=6, mf=4, use_nee=True)
    scenes = [scene_mod.fit_film(testing.cornell_scene(device=d), w, h)
              for d in (dev, torch.device('cpu'))]
    out = {}
    with torch.no_grad():
        for name in MLT_SAMPLERS:
            mod = _mlt_module(name)
            if name == 'ppm':
                res = [{'image': mod.render_sample(sc, cfg, 5)}
                       for sc in scenes]
            else:
                res = [kmlt.run_chains(sc, cfg, 5, 1, chains, 8,
                                       mod.STUCK_LIMIT, mod.MULT, mod.step)
                       for sc in scenes]
            card, cpu = ({k: v.cpu() for k, v in r.items()
                          if torch.is_tensor(v)} for r in res)
            top = float(cpu['image'].abs().max())
            share = float(torch.isclose(card['image'], cpu['image'], rtol=0,
                                        atol=1e-4 * top).all(-1).float().mean())
            mean_rel = abs(float(card['image'].mean() / cpu['image'].mean())
                           - 1.0)
            # the same final state: the same rejection count and the
            # primary samples within 1e-6 (exp on the card and on the CPU
            # may round a small step an ulp apart); the share with the
            # samples bit-equal is printed beside it
            same = bits = None
            if 'u' in card:
                rej = card['rejects'] == cpu['rejects']
                same = float((rej & torch.isclose(
                    card['u'], cpu['u'], rtol=0, atol=1e-6).all(-1))
                    .float().mean())
                bits = float((rej & (card['u'] == cpu['u']).all(-1))
                             .float().mean())
            print(f'{name}: pixels within 1e-4 of the largest {share:.4f} '
                  f'(bar 0.99), means {float(card["image"].mean()):.6g} vs '
                  f'{float(cpu["image"].mean()):.6g}'
                  + (f', chains in the same final state {same:.4f} (primary '
                     f'samples within 1e-6; bit-equal {bits:.4f})'
                     if same is not None else ''), flush=True)
            check(top > 0 and (share >= 0.99 or (
                same is not None and same >= 0.99 and mean_rel <= 1e-3)),
                f'{name} card against CPU: {share}, {same}, {mean_rel}')
            out[name] = dict(pixels=share, chains=same, chains_bits=bits,
                             mean_rel=mean_rel)
    return out


def mlt_ppm_phase(dev, card):
    """ppm, kmlt and vmlt on cornell at full width (mf=4, max_verts=6, NEE
    on, the reference defaults: 2 * W * H photon paths, 8192 chains): s a
    frame, launches, peak memory, one profiled frame each, the
    synchronizing calls of a mutation step, and the card against the
    CPU."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    phase(f'ppm, kmlt, vmlt on cornell {W}x{H}, mf=4, max_verts=6, on {card}')
    cornell = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                       device=dev), W, H)
    out = {}
    for name in MLT_SAMPLERS:
        t0 = time.perf_counter()
        warm, timed = (2, 3) if name == 'ppm' else (1, 2)
        out[name] = _mlt_frames(name, cornell, cfg, card, warm, timed)
        t1 = time.perf_counter()
        render = _mlt_module(name).render_sample
        out[name]['profile'] = _profile_frame(
            f'{name} frame', cornell, cfg, card,
            frame=lambda s: render(cornell, cfg, s),
            wall=out[name]['median_s'], cpu_ops=False)
        t2 = time.perf_counter()
        if name != 'ppm':
            out[name]['step_syncs'] = _mlt_step_syncs(name, cornell, cfg)
        print(f'{name}: phase seconds: frames {t1 - t0:.1f}, profile '
              f'{t2 - t1:.1f}, sync check {time.perf_counter() - t2:.1f}',
              flush=True)
    t0 = time.perf_counter()
    out['kernels_at_shapes'] = _kernels_at_mlt_shapes(cornell, cfg)
    print(f'forms at the ppm and MLT shapes: {time.perf_counter() - t0:.1f} s',
          flush=True)
    t0 = time.perf_counter()
    out['vs_cpu'] = _mlt_vs_cpu(dev)
    print(f'card against CPU: {time.perf_counter() - t0:.1f} s', flush=True)
    total = collections.Counter()
    for k in MLT_SAMPLERS:
        total.update(out[k]['launches'])
    out['launches'] = dict(total)
    return out


# --- phase 17: the sharded render and the inverse-rendering loop ------------

SHARD_RTOL, SHARD_ATOL = 2e-4, 1e-5      # tests/test_parallel.py:28-29


def _spread(times):
    return (f'min {min(times):.4f}, median {float(np.median(times)):.4f}, '
            f'max {max(times):.4f}')


def _held(a, b):
    """a against b at the JAX test's tolerance: the share of values within
    it and max |a - b|."""
    ok = (a - b).abs() <= SHARD_ATOL + SHARD_RTOL * b.abs()
    return float(ok.float().mean()), float((a - b).abs().max())


def _whole(scene, cfg, s):
    """The frame of sample s by the shard's own function over the whole
    film, as the one rank of mesh (1, 1) without a collective.  Held
    against it, a mesh checks the split of pixels and samples and the
    reduction, not the render: that is held to pt.render_sample
    (_off_carried)."""
    from corona13_tpu_torch.parallel import shard
    return shard.render_shard(scene, cfg, shard.make_mesh(), s, 0)


def _carried(scene, cfg, s):
    """The lanes of sample s whose continuous image coordinate rounded up
    to the next pixel (floor(pix_i) past the lane's own column, or pix_j
    past its row), and the pixels within the filter's reach of them (7x7
    around the lane's pixel).  pt.render_sample's pixel-aligned splat, as
    the JAX package's (corona13_tpu/samplers/pt.py:897-899), recovers the
    jitter as pix - floor(pix) = 0 and splats such a sample one pixel
    short; the general splat of a shard puts it where its coordinates
    are."""
    from corona13_tpu_torch.samplers import pt as pt_mod
    pix = torch.arange(W * H, device=scene.device)
    _, _, pi, pj = pt_mod.sample_paths(scene, cfg, s, pix)
    c = (torch.floor(pi) != pix % W) | (torch.floor(pj) != pix // W)
    near = torch.nn.functional.max_pool2d(
        c.reshape(1, 1, H, W).float(), 7, stride=1, padding=3)[0, 0] > 0
    return int(c.sum()), near


def _off_carried(img, ref, carried):
    """img against pt.render_sample's ref of the same samples, pixel by
    pixel at the JAX test's tolerance: the share of pixels within it, the
    pixels within reach of the samples carried into the next pixel (the
    masks of _carried), and the share within it off them."""
    ok = ((img - ref).abs() <= SHARD_ATOL + SHARD_RTOL * ref.abs()).all(-1)
    near = torch.stack([m for _, m in carried]).any(0)
    return float(ok.float().mean()), near, float(ok[~near].float().mean())


def _shard_frames(scene, cfg, card, warm=2, timed=3):
    """render_samples_sharded over the world-size-1 mesh and pt.render_sample
    at the same sample indices: warm untimed calls of each, then timed calls
    of each ending on the host (the launch counts zeroed just before the
    sharded ones and read just after), the peak memory and the profile of
    one sharded call.  The sharded images' sum is held to pt.render_sample's
    off the reach of the samples it splats one pixel short (_off_carried),
    and to the shard function's frames of the same samples (_whole): at
    world size 1 the latter checks only the path through the collective."""
    from corona13_tpu_torch.parallel import shard
    from corona13_tpu_torch.samplers import pt as pt_mod
    mesh = shard.make_mesh()
    sharded = lambda s: shard.render_samples_sharded(
        scene, cfg, mesh, s, device=scene.device)
    single = lambda s: pt_mod.render_sample(scene, cfg, s)
    out = {}
    samples = range(warm, warm + timed)
    with torch.no_grad():
        for s in range(warm):
            sharded(s)
            single(s)
        torch.cuda.synchronize()
        for name, fn in (('sharded', sharded), ('single', single)):
            if name == 'sharded':
                _zero_launches()
            times, total = [], 0
            for s in samples:
                t0 = time.perf_counter()
                img = fn(s)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                total = total + img
            out[name] = dict(frame_s=times, median_s=float(np.median(times)),
                             image=total)
            if name == 'sharded':
                out[name]['launches'] = _read_launches()
        torch.cuda.reset_peak_memory_stats()
        sharded(warm + timed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / GB
        whole = sum(_whole(scene, cfg, s) for s in samples)
        carried = [_carried(scene, cfg, s) for s in samples]
    img, img1 = out['sharded'].pop('image'), out['single'].pop('image')
    share, err = _held(img, whole)
    same = bool(torch.equal(img, whole))
    n_carried = sum(c for c, _ in carried)
    share1, near, share_off = _off_carried(img, img1, carried)
    t_sh, t_si = out['sharded']['median_s'], out['single']['median_s']
    overhead = 1.0 - t_si / t_sh
    launches = out['sharded']['launches']
    print(f'sharded frame: {_spread(out["sharded"]["frame_s"])} s; '
          f'unsharded pt.render_sample: {_spread(out["single"]["frame_s"])} '
          f's; overhead share at world size 1 (1 - t_single / t_sharded, '
          f'medians) {overhead:.4f}; peak memory {peak:.3f} GB; kernel '
          f'launches {launches} over {timed} frames on {card}', flush=True)
    print(f'the collective at world size 1: sharded images of samples '
          f'{warm}..{warm + timed - 1} against render_shard of the whole film '
          f'without it (the same function, so not a check of the render): '
          f'within rtol {SHARD_RTOL}, atol {SHARD_ATOL} on {share:.6f}, max '
          f'|diff| {err:.3g}, bit-equal {same}', flush=True)
    print(f'against pt.render_sample (pixel-aligned splat): pixels within the '
          f'tolerance {share1:.6f}; {n_carried} samples carried into the next '
          f'pixel, {int(near.sum())} pixels within their reach; off them '
          f'{share_off:.6f}', flush=True)
    check(share == 1.0, f'sharded frame against render_shard of the whole '
          f'film: {share}, {err}')
    check(share_off == 1.0, f'sharded against render_sample off the carried '
          f'samples: {share_off}')
    per = cfg.max_verts - 1
    expect = {k: per * timed for k in ('closest', 'any',
                                       'dense_sphere_closest',
                                       'dense_sphere_any')}
    check(launches == expect, f'sharded launches {launches}, expected '
          f'{expect}')
    prof = {k: _profile_frame(f'{k} frame', scene, cfg, card, frame=fn,
                              wall=out[k]['median_s'], cpu_ops=False)
            for k, fn in (('sharded', sharded), ('single', single))}
    return dict(sharded=out['sharded'], single=out['single'],
                overhead_share=overhead, peak_gb=peak, profile=prof,
                launches=launches,
                launches_per_frame={k: v / timed for k, v in launches.items()},
                vs_whole=dict(share=share, max_abs_diff=err, bit_equal=same),
                vs_render_sample=dict(share=share1, carried=n_carried,
                                      near_pixels=int(near.sum()),
                                      share_off_carried=share_off))


def _emulated_meshes(scene, cfg, card):
    """Meshes (2, 2) and (1, 4) run rank after rank on the card: the sum of
    the shards against pt.render_sample of the mesh's samples off the reach
    of the samples it carries (_off_carried), and against the shard
    function's own frames of the whole film (_whole), a check of the split
    alone."""
    from corona13_tpu_torch.parallel import shard
    from corona13_tpu_torch.samplers import pt as pt_mod
    out = {}
    with torch.no_grad():
        whole = [_whole(scene, cfg, s) for s in (0, 1)]
        single = [pt_mod.render_sample(scene, cfg, s) for s in (0, 1)]
        carried = [_carried(scene, cfg, s) for s in (0, 1)]
        for n_sp, n_px in ((2, 2), (1, 4)):
            mesh = shard.make_mesh(n_sp, n_px)
            t0 = time.perf_counter()
            fb = shard.render_samples_sharded(scene, cfg, mesh, 0,
                                              emulate=True,
                                              device=scene.device)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            share, err = _held(fb, sum(whole[:n_sp]))
            share1, near, share_off = _off_carried(
                fb, sum(single[:n_sp]), carried[:n_sp])
            print(f'mesh ({n_sp}, {n_px}) emulated on {card}: {mesh.size} '
                  f'shards of {W * H // n_px} rays in {sec:.3f} s; their sum '
                  f'against pt.render_sample of the same samples within rtol '
                  f'{SHARD_RTOL}, atol {SHARD_ATOL} on {share1:.6f} of the '
                  f'pixels, {share_off:.6f} off the {int(near.sum())} within '
                  f'reach of carried samples; the split against render_shard '
                  f'of the whole film on {share:.6f}, max |diff| {err:.3g}',
                  flush=True)
            check(share_off == 1.0, f'mesh ({n_sp}, {n_px}) against '
                  f'render_sample off the carried samples: {share_off}')
            check(share == 1.0, f'mesh ({n_sp}, {n_px}) split: {share}, '
                  f'{err}')
            out[f'{n_sp}x{n_px}'] = dict(
                share=share, max_abs_diff=err, seconds=sec,
                vs_render_sample=dict(share=share1, near_pixels=int(near.sum()),
                                      share_off_carried=share_off))
    return out


def _kernels_at_shard_shapes(scene, cfg):
    """The traversal forms at the shapes a shard gives them, captured from
    render_shard's own calls: the second bounce and the second NEE batch of
    the last rank of mesh (2, 2) (W * H / 2 rays) and of mesh (1, 4)
    (W * H / 4 rays), each against its plain version on the same tensors."""
    from corona13_tpu_torch.parallel import shard
    phase(f'the traversal forms against plain at the shard shapes, cornell '
          f'{W}x{H}')
    out = {}
    for n_sp, n_px in ((2, 2), (1, 4)):
        mesh = shard.make_mesh(n_sp, n_px)
        where = f'shard ({n_sp}, {n_px}) rank {mesh.size - 1}'
        out[where] = _hold_calls(where, _capture_calls(
            lambda: shard.render_shard(scene, cfg, mesh, 0, mesh.size - 1),
            W * H // n_px, {'closest_hit': 1, 'any_hit': 1}))
    print('tolerance: as at the ppm and MLT shapes', flush=True)
    return out


def shard_phase(dev, card):
    """parallel.shard and parallel.dryrun on the card in an NCCL process
    group of world size 1 (a file:// store under a temporary directory):
    the sharded cornell frame at full width timed beside pt.render_sample,
    emulated meshes, the forms at the shard shapes, and the training loop
    of dryrun_multichip(1)."""
    import torch.distributed as dist
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.parallel import dryrun
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, use_nee=True)
    phase(f'sharded render: cornell {W}x{H}, mf=4, max_verts=6, NEE, on '
          f'{card}')
    cornell = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                       device=dev), W, H)
    torch.cuda.set_device(cornell.device)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', init_method='file://' + os.path.join(
            tmp, 'store'), rank=0, world_size=1)
        try:
            print(f'world size {dist.get_world_size()}: this machine has one '
                  f'H100 (NCCL, backend {dist.get_backend()})', flush=True)
            out = _shard_frames(cornell, cfg, card)
            out['meshes'] = _emulated_meshes(cornell, cfg, card)
            out['kernels_at_shapes'] = _kernels_at_shard_shapes(cornell, cfg)
            phase(f'dryrun_multichip(1) on {card}: cornell_subsurf 256x144, '
                  f'max_verts=7, mf=2, NEE and media, 3 Adam steps')
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = dryrun.dryrun_multichip(1, device=dev)
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / GB
        finally:
            dist.destroy_process_group()
    print(f'dryrun: losses {run["losses"]}, seconds a step '
          f'{[round(t, 4) for t in run["step_s"]]}, {sec:.1f} s in all with '
          f'the target render, peak memory {peak:.3f} GB on {card}',
          flush=True)
    check(all(np.isfinite(run['losses'])) and run['losses'][-1]
          < run['losses'][0], f'dryrun losses {run["losses"]}')
    out['dryrun'] = dict(losses=run['losses'], step_s=run['step_s'],
                         seconds=sec, peak_gb=peak, grads={
                             k: v.tolist() for k, v in run['grads'].items()})
    print(f'sharded phase: {time.perf_counter() - t_start:.1f} s', flush=True)
    return out


def main():
    smi = device_phase()
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    dev = torch.device('cuda')
    gpu = torch.cuda.get_device_name(0)
    build_phase()
    kres, bvhs, cases = kernel_phase(dev, smi)
    callers = callers_phase(bvhs, kres, smi)
    fres, flaunches, line_sets = forms_phase(dev, smi, bvhs)
    lcres, lclaunches = line_counters_phase(line_sets, smi)
    del line_sets

    cornell = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                       device=dev), W, H)
    spp = 4
    res, lit, launches, rays = render_phase(
        'cornell', cornell, spp, gpu,
        forms=('closest', 'any', 'dense_sphere_closest', 'dense_sphere_any'))
    check(lit >= 0.95, f'only {lit} of the pixels are lit')
    path_close = paths_against_cpu(
        'main path (cornell)', lambda d: testing.cornell_scene(device=d), 64, 36,
        dev, max_verts=6)

    plane = scene_mod.fit_film(testing.plane_scene(device=dev), W, H)
    res2, lit2, launches2, rays2 = render_phase('plane (8198 triangles)', plane,
                                                2, gpu)
    plane_edges = plane_edges_phase(plane, smi)
    cres, claunches = counters_phase(cases, kres, smi)
    del bvhs, cases
    gold = golden_phase(dev)
    media = media_paths_phase(dev, smi)
    media_close = paths_against_cpu(
        'media path (0031_hete)', lambda d: scene_mod.load_scene(
            _scene_path('0031_hete'), device=d)[0], 64, 40, dev, max_verts=8,
        media=True)
    prims = prims_phase(dev, gpu)
    spheres = sphere_frame_phase(dev, smi)
    zoom = zoom_frame_phase(dev, smi)
    cli_mean = cli_phase()
    sky, sky_scene = sky_phase(dev, smi)
    compact = compact_phase(dev, smi)
    grad = grad_phase(dev, smi)
    dbor_vis = dbor_vis_phase(dev, sky_scene, smi)
    light = light_paths_phase(dev, smi)
    mlt = mlt_ppm_phase(dev, smi)
    sharded = shard_phase(dev, smi)
    # launches of the light-path, the ppm / MLT and the sharded frames
    lpl = collections.Counter(light['launches'])
    lpl.update(mlt['launches'])
    lpl.update(sharded['launches'])

    common = {'route': 'cuda',
              'source': 'corona13_tpu_torch/csrc/traverse_tris.cu',
              'replaces': 'corona13_tpu/ops/trace_pallas.py:284',
              'library_ms': None}   # no PyTorch call walks a BVH

    def at_shapes(key, run=mlt):
        # the least agreement with the plain version at the ppm / MLT shapes
        # (or at a shard's shapes)
        got = [v['agree'] for d in run['kernels_at_shapes'].values()
               for k, v in d.items() if k == key]
        return min(got) if got else None

    def entry(key, name):
        # the main path's shapes: cornell BVH, 589,824 bounce / shadow rays;
        # any-hit as trace.occluded launches it (only the flag written)
        case = 'cornell/shadow' if key == 'any' else 'cornell/bounce'
        m, c = kres[key][case], cres[case]
        ms = m['flag_ms'] if key == 'any' else m['ms']
        return {'name': name, **common,
                'launches': launches[key] + lpl.get(key, 0),
                'launches_per_frame': launches[key] / spp,
                'launches_per_sky_frame': sky['envmap']['launches'][key] / 2,
                'launches_per_light_frame': {
                    k: light[k]['launches_per_frame'].get(key, 0)
                    for k in LIGHT_SAMPLERS},
                'launches_per_ppm_mlt_frame': {
                    k: mlt[k]['launches_per_frame'].get(key, 0)
                    for k in MLT_SAMPLERS},
                'launches_per_sharded_frame':
                    sharded['launches_per_frame'].get(key, 0),
                'max_abs_err': m['max_abs_err'],
                'agree_at_ppm_mlt_shapes': at_shapes(key),
                'agree_at_shard_shapes': at_shapes(key, sharded), 'ms': ms,
                'plain_ms': m['plain_ms'], 'bound_ms': c['bound_ms'],
                'bound_by': c['bound_by'],
                'roofline_share': c['bound_ms'] / ms}
    m = cres['plane/bounce']     # the counters at a real BVH's bounce rays
    counters = {'name': 'traverse_tris counters', **common,
                'definition': 'the union walk of each 128-ray tile, the TPU '
                              'kernel\'s counts (earlier rows of this name '
                              'timed the per-ray walk: not comparable)',
                'launches': claunches['counters'],
                'launches_per_frame': launches['counters'] / spp,
                'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                'plain_ms': m['plain_ms'], 'bound_ms': m['union_bound_ms'],
                'bound_by': m['union_bound_by'],
                'roofline_share': m['union_bound_ms'] / m['ms'],
                'lane_share': m['lane_share'],
                'bits_equal_share': m['bits_equal_share']}
    per_ray = {'name': 'traverse_tris per-ray counters', **common,
               'replaces': None,
               'definition': 'the per-ray walk with each ray\'s own pops '
                             '(simple_walk), the persistent walk\'s '
                             'yardstick: no port of a TPU kernel',
               'launches': claunches['tri_counters'],
               'launches_per_frame': launches['tri_counters'] / spp,
               'max_abs_err': m['simple_max_abs_err'], 'ms': m['ms_simple'],
               'plain_ms': m['simple_plain_ms'],
               'bound_ms': m['simple_bound_ms'],
               'bound_by': m['simple_bound_by'],
               'roofline_share': m['simple_bound_ms'] / m['ms_simple']}
    print(json.dumps({'device': smi, 'kernel_cases': kres, 'callers': callers,
                      'counter_cases': cres, 'golden': gold, 'render': {
        'cornell': {'frame_s': res.seconds / spp, 'rays': rays,
                    'mrays_per_s': rays / res.seconds / 1e6,
                    'lit_share': lit, 'paths_vs_cpu': path_close},
        'plane': {'frame_s': res2.seconds / 2, 'rays': rays2,
                  'mrays_per_s': rays2 / res2.seconds / 1e6,
                  'lit_share': lit2, 'edge_rays': plane_edges}, **media,
        **prims, 'spheres': spheres, 'zoom': zoom,
        '0031_hete/paths_vs_cpu': media_close,
        'cli_mean': cli_mean}, 'form_cases': fres, 'sky': sky,
        'line_counter_cases': lcres,
        'compact': compact, 'grad': grad, 'dbor_vis': dbor_vis,
        'light_paths': light, 'ppm_mlt': mlt, 'sharded': sharded}),
        flush=True)

    def form_entry(key):
        # launches: the render that reaches the form (cornell: the dense
        # sphere list, also in the light-path frames; 0002_mb: moving
        # triangles; the hair frame: the line BVH; the sphere frame: the
        # sphere BVH; the zoom frame: the deep tree), else the intersect /
        # occluded calls of phase 3b (the skip form)
        form = key.rsplit('_', 1)[0]
        mode = 'any_hit' if key.endswith('any') else 'closest_hit'
        run, frames = {'dense_sphere': (launches, spp),
                       'moving': (prims['0002_mb']['launches'], 2),
                       'line': (prims['hair']['launches'], 2),
                       'sphere': (spheres['launches'], 2),
                       'deep': (zoom['launches'], 2)}.get(
            form, (flaunches, None))
        m = fres[key]
        dense = key.startswith('dense')
        # the line, moving, sphere, deep and skip forms: beside 3b's
        # numbers at the soup's shapes, the kernel at its frame's own shapes
        # (hair, 0002_mb: phase 8c; the sphere frame: 8d; the zoom frame:
        # 8e, the skip form on the same launches), the frame's sum and a
        # launch's mean
        shapes, frame = {
            'line': ('hair', prims['frame_forms']['hair'].get(key)),
            'moving': ('0002_mb', prims['frame_forms']['0002_mb'].get(key)),
            'sphere': ('sphere', spheres['frame_forms'].get(key)),
            'deep': ('zoom', zoom['frame_forms'].get(key)),
            'skip': ('zoom', zoom['frame_forms'].get(key))}.get(
            form, (None, None))
        at_frame = {}
        if form in ('deep', 'skip'):
            at_frame.update(
                plane_edge_rays_differ=plane_edges[form][mode]['differ'],
                zoom_edge_rays_differ=zoom['edges'][form][mode]['differ'])
        if form == 'sphere':
            at_frame.update(
                frame_edge_rays_differ=spheres['edges']['spheres'][mode][
                    'differ'],
                soup_edge_rays_differ=spheres['edges']['sphere soup'][mode][
                    'differ'])
        if frame:
            nf = frame['launches']
            at_frame.update({
                'frame_shapes': f'{shapes} frame, {nf} launches',
                'frame_ms': frame['ms'], 'frame_bound_ms': frame['bound_ms'],
                'frame_plain_ms': frame['plain_ms'],
                'frame_ms_per_launch': frame['ms_per_launch'],
                'frame_bound_ms_per_launch': frame['bound_ms_per_launch'],
                'frame_plain_ms_per_launch': frame['plain_ms'] / nf,
                'frame_bound_by': max(frame['calls'],
                                      key=lambda c: c['bound_ms'])['bound_by'],
                'frame_roofline_share': frame['roofline_share'],
                'frame_max_abs_err': frame['max_abs_err']})
            if 'exit_bound_ms' in frame:
                at_frame.update(
                    frame_exit_bound_ms=frame['exit_bound_ms'],
                    frame_exit_roofline_share=frame['exit_roofline_share'])
            if 'static_ms' in frame:
                at_frame.update(
                    frame_static_ms=frame['static_ms'],
                    frame_static_ms_per_launch=frame['static_ms_per_launch'],
                    frame_edge_rays_differ=prims['frame_forms'][
                        '0002_mb_edges'][mode]['differ'])
        if 'exit_bound_ms' in m:
            at_frame.update(exit_bound_ms=m['exit_bound_ms'],
                            exit_roofline_share=m['exit_bound_ms'] / m['ms'])
        return {'name': f'trace {key.replace("_", " ")}', **common,
                'replaces': 'corona13_tpu/ops/trace.py:' + (
                    '605-614,630-638' if dense else '359-440')
                + ' (XLA, not Pallas)',
                'launches': run[key] + lpl.get(key, 0),
                'launches_per_frame': run[key] / frames if frames else None,
                'launches_per_sharded_frame':
                    sharded['launches_per_frame'].get(key, 0),
                'max_abs_err': m['max_abs_err'],
                'agree_at_ppm_mlt_shapes': at_shapes(key),
                'agree_at_shard_shapes': at_shapes(key, sharded),
                'ms': m['ms'],
                'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                'bound_by': m['bound_by'],
                'roofline_share': m['bound_ms'] / m['ms'], **at_frame}
    m = lcres['closest']   # the line counters on the soup's bounce rays
    line_counters = {
        'name': 'trace line counters', **common,
        'replaces': 'corona13_tpu/ops/trace.py:359-440 (XLA, not Pallas)',
        'launches': lclaunches['line_counters'], 'launches_per_frame': 0,
        'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
        'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
        'bound_by': m['bound_by'], 'roofline_share': m['bound_ms'] / m['ms']}
    kernels = [entry('closest', 'traverse_tris closest-hit'),
               entry('any', 'traverse_tris any-hit'), counters, per_ray] + [
        form_entry(k) for k in fres] + [line_counters]
    for k in kernels:
        check(k['launches'] > 0, f'{k["name"]} was never launched on its path')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': gpu,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
