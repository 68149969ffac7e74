"""How many lanes of a 128-ray tile the union walk keeps busy (CPU).

    python3 scripts/union_lanes.py [--trees plane,soup]

The want_counters walk (``trace_cuda.union_walk_plain``, what the union
kernel computes on the card) pops, for each 128-ray tile, the union of its
rays' hits; the per-ray walk (``traverse_tris_plain(ray_pops=True)``, what
``simple_walk`` and the persistent launches walk) pops each ray's own.
For chip_smoke.py's phase 3 rays (camera, bounce, shadow; any-hit for the
shadow segments) on the plane scene's tree and on the 2^17-triangle soup,
this prints per tree and kind: the union's inner and leaf pops a tile,
the per-ray pops a ray, the live lanes a tile, the lane share and,
scaled from the window to 589,824 rays, the union kernel's bound, both
by chip_smoke.union_lanes (the bound: operations over the union pops'
tests on the lanes open at each pop).  The window: 65,536 rays, from
the middle rows of the plane's 1024x576 film, the first of the soup's
sets.  Runs on the CPU with the plain walks; no card."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ('camera', 'bounce', 'shadow')
N = 1 << 16          # rays in the window


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trees', default='plane,soup')
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.ops import trace_cuda
    cpu = torch.device('cpu')
    out = {}
    for tree in args.trees.split(','):
        t0 = time.time()
        if tree == 'plane':
            scene = scene_mod.fit_film(testing.plane_scene(device=cpu),
                                       cs.W, cs.H)
            geom = scene.geom
            sets = cs._ray_sets(geom, scene, cpu, 3)
            lo = (cs.N_RAYS // 2 - N // 2) // 128 * 128
        else:
            geom = trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                                  device=cpu)
            sets = cs._soup_sets(cpu, 5)
            lo = 0
        b = geom.tri_bvh
        print(f'{tree}: {b.wbounds.shape[0]} wide nodes, '
              f'{b.leaf_packed.shape[0]} leaves, rays made in '
              f'{time.time() - t0:.1f} s', flush=True)
        for kind in KINDS:
            o, d, ig, *tm = (x[lo:lo + N].contiguous() for x in sets[kind])
            t = tm[0] if tm else torch.full((N,), cs.MAX_DIST)
            ah = kind == 'shadow'
            t0 = time.time()
            u = trace_cuda.union_walk_plain(b.wbounds, b.wlinks,
                                            b.leaf_packed, o, d, t, ig,
                                            any_hit=ah, tile_stats=True)
            r = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks,
                                               b.leaf_packed, o, d, t, ig,
                                               any_hit=ah, ray_pops=True)
            t_iters, t_leafs, live = u[7:10]
            tiles = t_iters.numel()
            inner_r, leaf_r = int(r[5].sum()), int(r[6].sum())
            alive = int(live.sum())
            scale = cs.N_RAYS / N
            share, bound, by = cs.union_lanes(b, cs.N_RAYS, alive * scale,
                                              True, u[7:], inner_r, leaf_r,
                                              scale)
            rec = dict(union_inner_per_tile=int(t_iters.sum()) / tiles,
                       union_leaf_per_tile=int(t_leafs.sum()) / tiles,
                       inner_per_ray=inner_r / N, leaf_per_ray=leaf_r / N,
                       live_per_tile=alive / tiles, lane_share=share,
                       union_pops_full=int((t_iters + t_leafs).sum())
                       * scale, bound_ms_full=bound, bound_by=by,
                       same_hits=bool(torch.equal(u[1], r[1])))
            out[f'{tree}/{kind}'] = rec
            print(f'  {tree} {kind} ({"any" if ah else "closest"}-hit, '
                  f'{N} rays): union pops a tile '
                  f'{rec["union_inner_per_tile"]:.1f} inner / '
                  f'{rec["union_leaf_per_tile"]:.1f} leaf; per-ray pops a '
                  f'ray {rec["inner_per_ray"]:.2f} / {rec["leaf_per_ray"]:.2f}'
                  f'; live lanes a tile {rec["live_per_tile"]:.1f}; lane '
                  f'share {rec["lane_share"]:.4f}; at {cs.N_RAYS} rays the '
                  f'union pops {rec["union_pops_full"]:.3g}, bound '
                  f'{bound:.4f} ms by {by}; prim equal to the per-ray walk '
                  f'{rec["same_hits"]} ({time.time() - t0:.1f} s)',
                  flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
