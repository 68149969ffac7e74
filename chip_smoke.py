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
     sphere and the line policy (2^16 prims each), the
     deep-tree skip-link walk on the triangle soup, and the dense list on
     cornell's one sphere and on 64 lines; two launches bit-identical;
     then trace.intersect / trace.occluded on geometries that route to
     the forms no render below reaches (launch counts asserted);
  4. main path: render.render of testing.cornell_scene at 1024x576, mf=4,
     max_verts=6, NEE on, 4 spp, through the kernel (launch counts
     checked), plus the same path on the card against the CPU at 64x36;
  5. larger BVH: the plane scene rendered the same way at 2 spp;
  6. counters: the kernel with want_counters (the simple walk, thread i on
     ray i) on the cornell, plane and soup BVHs at 589,824 rays,
     closest-hit and any-hit, against the plain walk (equal pops per
     1024-ray block), timed in turns with the render path's persistent
     launch on the same rays;
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
  9. media path on the card against the CPU: sample_paths of 0031_hete at
     64x40;
 10. the CLI: python -m corona13_tpu_torch on 0031_hete, 256x160, 2 spp.
The line before the last is a JSON record of the kernels, each with its
bound on this card: the larger of its bytes (inputs once, outputs once,
dead lanes only their t_init) over 3.35 TB/s and its float operations (the
pops this run's rays needed, on occupied children and rows; for the forms
of 3b the box and leaf tests of the plain skip-link walk on the same rays)
over 67 TFLOP/s.  The last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

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
    # ptxas -v: registers, stack frame and spills of each instantiation
    # (kernel, leaf policy, then the template flags: any-hit, and for the
    # wide walk counters and persistent)
    name, n_kernels = None, 0
    for line in trace_cuda.build_log.splitlines():
        if 'Compiling entry function' in line:
            m = re.search(r'\d+(traverse|skip|dense)_kernelINS_\d+(\w+?)Leaf'
                          r'E((?:Lb[01]E)+)', line)
            check(m is not None, f'unexpected kernel name: {line}')
            flags = re.findall(r'Lb([01])E', m.group(3))
            name = f'{m.group(1)} {m.group(2)} ' + \
                ('any-hit' if flags[0] == '1' else 'closest-hit')
            if m.group(1) == 'traverse':
                name += (' counters' if flags[1] == '1' else '') + \
                    (' persistent' if flags[2] == '1' else ' simple')
            n_kernels += 1
        elif name and ('registers' in line or 'stack frame' in line):
            print(f'  {name}: {line.split(":", 1)[-1].strip()}', flush=True)
    print(f'{n_kernels} kernel instantiations', flush=True)


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


def _time_ms(fn, n_sets, reps, host=False):
    """Mean card ms per call over reps calls cycling over n_sets input
    sets, between CUDA events, ending in a synchronize and a read-back.
    A dry pass measures how long the host takes to enqueue the calls; a
    spin kernel half as long again (at an SM clock of at most 2 GHz) then
    goes first, so that the host has enqueued every call before the card
    starts on them: the events bracket the card's time, not the host's
    pace of launching.  If the spin has ended by the time the host is done
    the pass is host-bound and is taken again behind twice the spin (at
    most three passes).  host=True also returns the host's microseconds
    per call to enqueue and whether the last pass was still host-bound."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i % n_sets)
    spin_s = (time.perf_counter() - t0) * 1.5 + 1e-3
    for _ in range(3):
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


def kernel_phase(dev, card):
    from corona13_tpu_torch import testing
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    phase(f'kernel against plain, {N_RAYS} rays per call, on {card}')
    # an entry point without a device argument: it builds on the card
    cornell = testing.cornell_scene()
    check(cornell.device.type == 'cuda', f'cornell_scene() built on '
          f'{cornell.device}, not on the card')
    cornell = scene_mod.fit_film(cornell, W, H)
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
    puts on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
# box test, OPS_CHILD.
OPS_ROW_OF = {'tri': OPS_ROW, 'moving': OPS_ROW + 28, 'sphere': 25, 'line': 75}
OPS_PRIM_OF = {'tri': 0, 'moving': 0, 'sphere': 1, 'line': 15}


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


def _form_bound(target, kind, form, n, alive, out_bytes, visits, leafs):
    """The least time the card could take for one fresh launch of a form:
    (ms, 'bytes' or 'operations').  Bytes: the records the form reads once
    (a tree's nodes and leaf rows, a dense list's arrays), 24 B of origin
    and direction and 8 B of ignore id for a live ray, 4 B of ray time for
    a live ray of a form that lerps (moving triangles, a dense sphere list
    with shutter-close centres; the others are given no time), t_init and
    ``out_bytes`` of outputs for every ray.  Operations: 12 a live ray; what
    a test computes from the prim alone once a prim; a tree: one box test a
    node visited and the leaf rows tested, as the plain skip-link walk
    counted them on these rays, at the tree's mean row fill; a dense list:
    every live ray against every prim."""
    if form == 'dense':
        recs = sum(x.numel() for x in target if x is not None) * 4
        n_prims = target[0].shape[0]
        lerps = kind == 'sphere' and target[2] is not None
        ops = (alive * (OPS_RAY + n_prims * (OPS_ROW_OF[kind] + 10 * lerps))
               + n_prims * OPS_PRIM_OF[kind])
    else:
        nodes = target.knodes if form == 'wide' else target.nodes
        lerps = kind == 'moving'
        rows = [target.kleaves] + ([target.kleaves_t1] if lerps else [])
        recs = (nodes.numel() + sum(r.numel() for r in rows)) * 4
        filled = target.leaf_prims >= 0
        ops = (alive * OPS_RAY + visits * OPS_CHILD
               + leafs * 8 * float(filled.float().mean()) * OPS_ROW_OF[kind]
               + int(filled.sum()) * OPS_PRIM_OF[kind])
    nbytes = recs + alive * (24 + 8 + 4 * lerps) + n * (4 + out_bytes)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


def _form_compare(k, p, any_hit, where):
    """A form's kernel against its plain version: the shares of rays that
    agree on prim, on slot and (any-hit) on blocked, and max |dt| where
    prim agrees.  Threshold: >= 99.9% on each, t within rtol 1e-6; the
    aim is 1.000000 and max |dt| 0, as the triangle cases have."""
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
    p = plain(want_counts=form != 'dense') if form != 'dense' else plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    visits = leafs = 0
    if form != 'dense':
        p, v, l = p
        visits, leafs = int(v.sum()), int(l.sum())
    agree, slot, err = _form_compare(first, p, any_hit, name)
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
    c_agree, c_slot, c_err = _form_compare(c1, pc, any_hit, name + ' carried')
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
    print(f'  {name:30s} {"any" if any_hit else "closest"}-hit ({form}): '
          f'alive {alive / n:.4f}, hit share {hit_share:.4f}, prim agree '
          f'{agree:.6f}, slot agree {slot:.6f}, max |dt| {err:.3g}; carried: '
          f'agree {c_agree:.6f} / {c_slot:.6f}, max |dt| {c_err:.3g}, '
          f'{improved} rays improved; two launches identical; kernel '
          f'{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms by '
          f'{by} (share {bound / ms:.3f})'
          + (f'; skip-link walk {visits / n:.2f} nodes / {leafs / n:.2f} '
             f'leaves a ray' if form != 'dense' else ''), flush=True)
    return dict(ms=ms, plain_ms=plain_ms, agree=min(agree, c_agree),
                slot_agree=min(slot, c_slot), max_abs_err=max(err, c_err),
                hit_share=hit_share, alive=alive, bound_ms=bound, bound_by=by,
                form=form, nodes_per_ray=visits / n, leaves_per_ray=leafs / n)


def forms_phase(dev, card, bvhs):
    """Phase 3b: see the module docstring.  Returns the per-case results
    keyed by the entry of trace_cuda.launches each case exercises, and the
    launch counts of the intersect / occluded calls that reach the forms no
    render reaches."""
    import dataclasses
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'forms that replace _traverse against plain, {N_RAYS} rays per '
          f'call, on {card}')
    t0 = time.time()
    tri = _soup(1 << 17, 7)
    g = np.random.default_rng(8)
    moving = trace_mod.make_device_geometry(
        tri_v=tri, tri_v_t1=tri + g.uniform(
            -1, 1, (len(tri), 1, 3)).astype(np.float32), device=dev)
    spheres = trace_mod.make_device_geometry(**_sphere_soup(1 << 16, 9),
                                             device=dev)
    lines = trace_mod.make_device_geometry(**_line_soup(1 << 16, 10),
                                           device=dev)
    print(f'moving soup (131072 triangles), sphere soup and line soup (65536 '
          f'each) built in {time.time() - t0:.1f} s; wide nodes '
          f'{moving.tri_bvh.knodes.shape[0]} / '
          f'{spheres.sph_bvh.knodes.shape[0]} / '
          f'{lines.line_bvh.knodes.shape[0]}, stack depths '
          f'{moving.tri_bvh.stack_depth} / {spheres.sph_bvh.stack_depth} / '
          f'{lines.line_bvh.stack_depth}', flush=True)
    soup, soup_a, soup_b = bvhs['soup']
    # the static soup's tree without its wide layout: walked by skip links
    deep = dataclasses.replace(soup.tri_bvh, wbounds=None, wlinks=None,
                               leaf_packed=None, knodes=None, stack_depth=0)
    cornell, corn_a, corn_b = bvhs['cornell']
    box = _line_soup(64, 12, box=4.0, length=3.0, radius=0.3)
    box['line_vtx'] = box['line_vtx'] + np.array([0, 0, 15], np.float32)
    few = trace_mod.make_device_geometry(**box, device=dev)
    dense_sph = (cornell.sph_c, cornell.sph_r, None)
    dense_line = (few.line_v0, few.line_v1, few.line_r0, few.line_r1)
    targets = {
        'moving': (moving.tri_bvh, 'moving', 0, (soup_a, soup_b)),
        'sphere': (spheres.sph_bvh, 'sphere', 1000, (soup_a, soup_b)),
        'line': (lines.line_bvh, 'line', 2000, (soup_a, soup_b)),
        'deep': (deep, 'tri', 0, (soup_a, soup_b)),
        'dense_sphere': (dense_sph, 'sphere', cornell.n_tris, (corn_a, corn_b)),
        'dense_line': (dense_line, 'line', 12, (corn_a, corn_b)),
    }
    gen = torch.Generator(device='cpu').manual_seed(13)
    res = {}
    for key, (target, kind, offset, sets) in targets.items():
        for mode, ray_kind in (('closest', 'bounce'), ('any', 'shadow')):
            argsets = []
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
    print('tolerance: prim, slot and blocked identical on >= 99.9% of rays, t '
          'within rtol 1e-6 where prim agrees (the aim, 1.000000 and max |dt| '
          '0, is printed per case); two launches of a case bit-identical',
          flush=True)
    # the forms no render of this script reaches, through the entry points
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    tm = torch.rand(N_RAYS, generator=gen).to(dev)
    deep_geom = dataclasses.replace(soup, tri_bvh=deep)
    for geom in (spheres, few, deep_geom):
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
          f'deep tree: launches {launches}', flush=True)
    check(launches == {f'{k}_{m}': 1 for k in ('sphere', 'dense_line', 'deep')
                       for m in ('closest', 'any')},
          f'form path launch counts {launches}')
    return res, launches


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


def counters_phase(cases, kres, card):
    """want_counters at the main path's shapes.  The counters' own path is
    one launch per case with the counts reset before and read after; the
    comparisons with the plain walk and the timings come after it.  The
    counters launch is the simple walk (thread i walks ray i), so its time
    in turns with the render path's launch on the same rays is the
    persistent design against the simple one."""
    from corona13_tpu_torch.ops import trace_cuda
    phase(f'counters: want_counters against plain, and the simple walk '
          f'against the persistent one, {N_RAYS} rays per call, on {card}')
    names = [f'{b}/{k}' for b in ('cornell', 'plane', 'soup')
             for k in ('bounce', 'shadow')]
    for k in trace_cuda.launches:
        trace_cuda.launches[k] = 0
    outs = [trace_cuda.traverse_tris(cases[n][0], *cases[n][2][0],
                                     any_hit=cases[n][1], want_counters=True)
            for n in names]
    torch.cuda.synchronize()
    launches = dict(trace_cuda.launches)
    print(f'counter launches {launches} (expected {len(names)} counters)',
          flush=True)
    check({k: v for k, v in launches.items() if v}
          == {'counters': len(names)}, f'counter launch counts {launches}')
    res = {}
    for name, out in zip(names, outs):
        b, ah, argsets = cases[name]
        k = [x.cpu().numpy() for x in out]
        p, plain_ms = _plain_timed(cases[name], want_counters=True)
        check(k[5].shape == (N_RAYS // 1024,), f'{name}: counter shape')
        blocks_eq = float(((k[5] == p[5]) & (k[6] == p[6])).mean())
        check(blocks_eq == 1.0, f'{name}: counters differ on '
              f'{1 - blocks_eq:.4%} of blocks')
        agree, err = _compare_hits(k, p, ah, name)
        # in turns: simple, persistent, persistent, simple; then the
        # counters wrapper, which adds the per-block sums to the simple walk
        simple = lambda s: trace_cuda.simple_walk(b, *argsets[s], any_hit=ah)
        if ah:
            pers = lambda s: (trace_cuda.occluded_tris(b, *argsets[s]),)
        else:
            pers = lambda s: trace_cuda.traverse_tris(b, *argsets[s])
        t_s, t_p = _time_ms(simple, 2, 20), _time_ms(pers, 2, 20)
        t_p += _time_ms(pers, 2, 20)
        t_s += _time_ms(simple, 2, 20)
        ms_simple, ms_pers = t_s / 2, t_p / 2
        ms = _time_ms(lambda s: trace_cuda.traverse_tris(
            b, *argsets[s], any_hit=ah, want_counters=True), 2, 20)
        inner, leaf = int(k[5].sum()), int(k[6].sum())
        m = kres['any' if ah else 'closest'][name]
        t_tensor = torch.is_tensor(argsets[0][2])
        bound, by = _bound_ms(b, N_RAYS, m['alive'], t_tensor, 1,
                              1 if ah else 28, inner, leaf)
        cbound, cby = _bound_ms(b, N_RAYS, m['alive'], t_tensor, 1, 36,
                                inner, leaf)
        print(f'  {name:14s} {"any" if ah else "closest"}-hit: blocks equal '
              f'{blocks_eq:.6f}, prim agree {agree:.6f}, max |dt| {err:.3g}; '
              f'pops per ray {inner / N_RAYS:.2f} inner / '
              f'{leaf / N_RAYS:.2f} leaf; simple walk '
              f'{ms_simple:.3f} ms ({ms:.3f} ms with the per-block sums), '
              f'persistent {ms_pers:.3f} ms, bound '
              f'{bound:.4f} ms by {by} (share {bound / ms_pers:.3f}), plain '
              f'{plain_ms:.1f} ms', flush=True)
        res[name] = dict(ms=ms, ms_simple=ms_simple, ms_persistent=ms_pers,
                         plain_ms=plain_ms,
                         max_abs_err=err, agree=agree, blocks_equal=blocks_eq,
                         inner_per_ray=inner / N_RAYS,
                         leaf_per_ray=leaf / N_RAYS, bound_ms=bound,
                         bound_by=by, counters_bound_ms=cbound,
                         counters_bound_by=cby)
    print('tolerance: iters and leafs equal on every block; hits as phase 3',
          flush=True)
    return res, launches


# --- phase 4/5: the main path ----------------------------------------------

def render_phase(name, scene, spp, gpu_name, max_verts=6,
                 forms=('closest', 'any'), **kw):
    """One render through render.render with the launch counts zeroed just
    before and read just after: every form in ``forms`` must have been
    launched once a bounce, and no other."""
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
    moved = {k: v for k, v in launches.items() if v}
    print(f'kernel launches {moved} (expected {per} each of '
          f'{", ".join(forms)})', flush=True)
    check(moved == {k: per for k in forms},
          f'launch counts {moved}, expected {per} each of {forms}')
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


def main():
    smi = device_phase()
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    dev = torch.device('cuda')
    gpu = torch.cuda.get_device_name(0)
    build_phase()
    kres, bvhs, cases = kernel_phase(dev, smi)
    callers = callers_phase(bvhs, kres, smi)
    fres, flaunches = forms_phase(dev, smi, bvhs)

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
    cres, claunches = counters_phase(cases, kres, smi)
    del bvhs, cases
    gold = golden_phase(dev)
    media = media_paths_phase(dev, smi)
    media_close = paths_against_cpu(
        'media path (0031_hete)', lambda d: scene_mod.load_scene(
            _scene_path('0031_hete'), device=d)[0], 64, 40, dev, max_verts=8,
        media=True)
    prims = prims_phase(dev, gpu)
    cli_mean = cli_phase()

    common = {'route': 'cuda',
              'source': 'corona13_tpu_torch/csrc/traverse_tris.cu',
              'replaces': 'corona13_tpu/ops/trace_pallas.py:284',
              'library_ms': None}   # no PyTorch call walks a BVH

    def entry(key, name):
        # the main path's shapes: cornell BVH, 589,824 bounce / shadow rays;
        # any-hit as trace.occluded launches it (only the flag written)
        case = 'cornell/shadow' if key == 'any' else 'cornell/bounce'
        m, c = kres[key][case], cres[case]
        ms = m['flag_ms'] if key == 'any' else m['ms']
        return {'name': name, **common, 'launches': launches[key],
                'launches_per_frame': launches[key] / spp,
                'max_abs_err': m['max_abs_err'], 'ms': ms,
                'plain_ms': m['plain_ms'], 'bound_ms': c['bound_ms'],
                'bound_by': c['bound_by'],
                'roofline_share': c['bound_ms'] / ms}
    m = cres['plane/bounce']     # the counters at a real BVH's bounce rays
    counters = {'name': 'traverse_tris counters', **common,
                'launches': claunches['counters'],
                'launches_per_frame': launches['counters'] / spp,
                'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                'plain_ms': m['plain_ms'], 'bound_ms': m['counters_bound_ms'],
                'bound_by': m['counters_bound_by'],
                'roofline_share': m['counters_bound_ms'] / m['ms']}
    print(json.dumps({'device': smi, 'kernel_cases': kres, 'callers': callers,
                      'counter_cases': cres, 'golden': gold, 'render': {
        'cornell': {'frame_s': res.seconds / spp, 'rays': rays,
                    'mrays_per_s': rays / res.seconds / 1e6,
                    'lit_share': lit, 'paths_vs_cpu': path_close},
        'plane': {'frame_s': res2.seconds / 2, 'rays': rays2,
                  'mrays_per_s': rays2 / res2.seconds / 1e6,
                  'lit_share': lit2}, **media,
        **prims, '0031_hete/paths_vs_cpu': media_close,
        'cli_mean': cli_mean}, 'form_cases': fres}), flush=True)

    def form_entry(key):
        # launches: the render that reaches the form (cornell: the dense
        # sphere list; 0002_mb: moving triangles; the hair frame: the line
        # BVH), else the intersect / occluded calls of phase 3b
        run, frames = {'dense_sphere': (launches, spp),
                       'moving': (prims['0002_mb']['launches'], 2),
                       'line': (prims['hair']['launches'], 2)}.get(
            key.rsplit('_', 1)[0], (flaunches, None))
        m = fres[key]
        dense = key.startswith('dense')
        return {'name': f'trace {key.replace("_", " ")}', **common,
                'replaces': 'corona13_tpu/ops/trace.py:' + (
                    '605-614,630-638' if dense else '359-440')
                + ' (XLA, not Pallas)',
                'launches': run[key],
                'launches_per_frame': run[key] / frames if frames else None,
                'max_abs_err': m['max_abs_err'], 'ms': m['ms'],
                'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                'bound_by': m['bound_by'],
                'roofline_share': m['bound_ms'] / m['ms']}
    kernels = [entry('closest', 'traverse_tris closest-hit'),
               entry('any', 'traverse_tris any-hit'), counters] + [
        form_entry(k) for k in fres]
    for k in kernels:
        check(k['launches'] > 0, f'{k["name"]} was never launched on its path')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': gpu,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
