"""Card time of trace.intersect and trace.occluded on one CUDA card.

    python3 scripts/trace_times.py [--root TREE] [--cases A,B]

Cases (--cases names a subset; all by default):
  calls  the two calls the sampler makes, wrapper and kernel together, on
         chip_smoke.py's rays (589,824 a call) over three triangles-only
         BVHs: the cornell box without its sphere, the 8198-triangle plane
         scene and a 2^17-triangle random soup; and on the cornell box with
         its sphere, whose call adds the sphere test to the triangle walk.
         intersect gets the bounce rays with a tensor t_max (3.4e38 on
         every lane, as the sampler passes it), occluded the shadow
         segments;
  lines  the same two calls on chip_smoke.py's 2^16-line soup (the line
         BVH form alone) with the soup's rays;
  hair   the line launches (line_closest, line_any) of one 1024x576 pt
         progression of chip_smoke.py's hair scene (65,536 fibres; mf=4,
         max_verts=6, NEE), captured from the frame's own intersect /
         occluded calls and launched again on the same tensors, each timed,
         given its bound (chip_smoke._form_bound, from the plain skip-link
         walk's visits on the same rays) and held against its plain
         version: chip_smoke.frame_forms;
  mb     the same for the moving-triangle launches of the 0002_mb frame,
         each beside the static walk of the same tree on the same rays
         (shutter-open rows, no time: the least the moving form could
         approach), the records' bytes a leaf pop, ptxas' registers of the
         moving instantiations, and the moving form on rays aimed at the
         edges the 0002_mb plane's leaves share (chip_smoke.edge_forms:
         the rays on which it differs from the plain walk, counted);
  spheres  the same for the sphere launches (sphere_closest, sphere_any)
         of one 1024x576 progression of chip_smoke.py's sphere frame
         (65,536 spheres: chip_smoke._sphere_scene), phase 3b's sphere
         soup (2^16 spheres, 589,824 rays) beside it, ptxas' registers of
         the sphere instantiations, and the sphere form on rays aimed at
         points two spheres of different leaves share (chip_smoke.
         sphere_edge_rays, on the frame's spheres and on the soup: the
         rays on which it differs from the plain walk, counted);
  zoom   the deep launches (deep_closest, deep_any) of one 1024x576
         progression of chip_smoke.py's zoom frame (a 65,536-triangle
         log-spiral ribbon whose tree is too deep for the wide stack:
         chip_smoke._zoom_scene) and the same launches by the skip form
         (the tree laid out as over the deep stack's limit), phase 3b's
         deep and skip forms on the 2^17-triangle soup (589,824 rays), both
         forms on rays aimed at edges two of the zoom tree's leaves share
         (the rays that differ from the plain walk, counted), ptxas'
         registers of the deep and skip instantiations, and the zoom
         frame's paths on the card against the CPU at 64x36 (a reading);
  edges  the plane scene's static tree on chip_smoke.edge_rays: its deep
         and skip forms and its wide walk, each against its plain
         version, the rays that differ counted;
  union  the union walk of want_counters (union_kernel: each 128-ray tile
         walks the union of its rays' hits) on chip_smoke.py's phase 6
         cases (cornell, plane and the 2^17-triangle soup; bounce rays
         closest-hit, shadow segments any-hit; 589,824 rays a call),
         each held to the plain union walk (every block's counts) and
         timed, with ptxas' registers of the union instantiations;
  profile  one hair progression under torch.profiler: device ms of each
         traversal form, total device ms, CUDA launches, busy share;
  forms  chip_smoke.py's phase 3b: every form that replaces XLA's
         _traverse (moving triangles, sphere and line BVHs, the deep tree,
         the dense lists) against its plain version at 589,824 rays,
         timed, with its bound;
  moving, dense_line  one form of 3b alone: the 2^17-triangle moving soup,
         or the 64 lines in the cornell box.
The timer is chip_smoke.py's: CUDA events behind a spin kernel that
outlasts the host's enqueueing, mean of 20 calls (a captured launch
that updates its carry in place gets a fresh clone each time, made
outside the timed window).  Prints card ms and host us per call with the
card's name and power limit.  --root names another checkout whose
corona13_tpu_torch to import: the calls have one signature across the
port's history, so two trees are compared under one timer by running this
script once per tree, in turns, on one card in one sitting.  This tree's
exact forms are held bit for bit to their plain walks (chip_smoke.
EXACT_KINDS, edge rays included); another tree's as the other forms are.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace_build_log():
    """nvcc's report on the traversal library (a checkout from before
    ``ops/cuda_lib.py`` keeps it in ``trace_cuda.build_log``)."""
    try:
        from corona13_tpu_torch.ops import cuda_lib
    except ImportError:
        from corona13_tpu_torch.ops import trace_cuda
        return trace_cuda.build_log
    return cuda_lib.build_logs['traverse_tris']


def union_times(cs, dev, card, root):
    """The union kernel on phase 6's cases: ms a launch, its pops a tile,
    held to the plain union walk's counts on every block."""
    from corona13_tpu_torch.ops import trace_cuda
    cases = cs.main_cases(cs.main_bvhs(dev)[0], dev)
    out = {}
    for name in [f'{b}/{k}' for b in ('cornell', 'plane', 'soup')
                 for k in ('bounce', 'shadow')]:
        b, ah, argsets = cases[name]
        union = lambda i: trace_cuda.traverse_tris(
            b, *argsets[i], any_hit=ah, want_counters=True)
        k = union(0)
        p = trace_cuda.union_walk_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                        *argsets[0], any_hit=ah)
        cs.check(torch.equal(k[5], p[5]) and torch.equal(k[6], p[6]),
                 f'{name}: union counts differ from plain (tree {root})')
        ms = cs._time_ms(union, 2, 20)
        pops = float((k[5].sum() + k[6].sum()).item()) / (cs.N_RAYS / 128)
        print(f'union {name} {"any" if ah else "closest"}-hit: {ms:.4f} ms, '
              f'{pops:.1f} pops a tile, counts equal to plain, on {card}, '
              f'tree {root}', flush=True)
        out[name] = dict(ms=ms, pops_per_tile=pops)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--cases', default='calls,lines,hair,mb,profile,forms')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    cases = args.cases.split(',')
    sys.path.insert(0, root)
    # the timer and the rays are this tree's, whichever package is timed
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if root != HERE:
        # an older checkout's moving form may differ from its plain walk in
        # a bit (before its walk took the reference's order): held as the
        # other forms are, and its edge rays counted, not gated
        cs.EXACT_KINDS = ()
    card = cs.device_phase()
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.ops import trace as trace_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    dev = torch.device('cuda')
    sets = {}
    if 'calls' in cases:
        cornell = scene_mod.fit_film(testing.cornell_scene(sphere=None,
                                                           device=dev),
                                     cs.W, cs.H)
        plane = scene_mod.fit_film(testing.plane_scene(device=dev), cs.W,
                                   cs.H)
        soup = trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                              device=dev)
        ball = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                        device=dev),
                                  cs.W, cs.H)
        sets.update({
            'cornell': (cornell.geom, [cs._ray_sets(cornell.geom, cornell,
                                                    dev, s) for s in (1, 2)]),
            'cornell+sphere': (ball.geom, [cs._ray_sets(ball.geom, ball, dev, s)
                                           for s in (1, 2)]),
            'plane': (plane.geom, [cs._ray_sets(plane.geom, plane, dev, s)
                                   for s in (3, 4)]),
            'soup': (soup, [cs._soup_sets(dev, s) for s in (5, 6)])})
    if 'lines' in cases:
        lines = trace_mod.make_device_geometry(**cs._line_soup(1 << 16, 10),
                                               device=dev)
        sets['lines'] = (lines, [cs._soup_sets(dev, s) for s in (5, 6)])
    t_live = torch.full((cs.N_RAYS,), cs.MAX_DIST, device=dev)
    out = {}
    from corona13_tpu_torch.ops import trace_cuda
    # the skip form beside the deep walk (a checkout from before it has its
    # skip-link walk under the deep form's name)
    has_skip = hasattr(trace_cuda, 'MAX_BIN_STACK')
    deep_keys = ['deep', 'skip'] if has_skip else ['deep']
    only = [c for c in ('moving', 'dense_line') if c in cases] + (
        ['sphere'] if 'spheres' in cases else []) + (
        deep_keys if 'zoom' in cases else [])
    if 'forms' in cases or only:
        soup = sets['soup'][0] if 'soup' in sets else \
            trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                           device=dev)
        ball = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                        device=dev),
                                  cs.W, cs.H)
        forms = cs.forms_phase(dev, card, {
            'soup': (soup, cs._soup_sets(dev, 5), cs._soup_sets(dev, 6)),
            'cornell': (ball.geom, cs._ray_sets(ball.geom, ball, dev, 1),
                        cs._ray_sets(ball.geom, ball, dev, 2))},
            only=None if 'forms' in cases else only)[0]
        out.update({f'form/{k}': dict(ms=v['ms'], bound_ms=v['bound_ms'])
                    for k, v in forms.items()})
    for name, (geom, rays) in sets.items():
        isect = lambda i: (trace_mod.intersect(
            geom, rays[i]['bounce'][0], rays[i]['bounce'][1],
            ignore_prim=rays[i]['bounce'][2], t_max=t_live).t,)
        occl = lambda i: (trace_mod.occluded(
            geom, rays[i]['shadow'][0], rays[i]['shadow'][1],
            rays[i]['shadow'][3], ignore_prim=rays[i]['shadow'][2],
            ignore_prim2=rays[i]['shadow'][2]),)
        for call, fn in (('intersect', isect), ('occluded', occl)):
            ms, host_us, host_bound = cs._time_ms(fn, 2, 20, host=True)
            out[f'{name}/{call}'] = dict(ms=ms, host_us=host_us,
                                         host_bound=host_bound)
            whose = "at the host's pace" if host_bound else 'of the card'
            print(f'{name} {call}: {ms:.4f} ms {whose} per call, host '
                  f'{host_us:.0f} us to enqueue one, on {card}, tree {root}',
                  flush=True)
    cfg = pt_mod.PTConfig(width=cs.W, height=cs.H, max_verts=6, mf=4,
                          use_nee=True)
    frames = {}
    if {'hair', 'profile'} & set(cases):
        hair = scene_mod.fit_film(cs._hair_scene(dev), cs.W, cs.H)
        if 'hair' in cases:
            frames['hair'] = cs.frame_forms(
                'hair', cs.frame_calls(hair, cfg),
                ('line_closest', 'line_any'), card)
        if 'profile' in cases:
            frames['hair profile'] = cs._profile_frame(
                f'hair frame (tree {root})', hair, cfg, card)
    if 'mb' in cases:
        mb = scene_mod.fit_film(scene_mod.load_scene(
            cs._scene_path('0002_mb'), device=dev)[0], cs.W, cs.H)
        frames['0002_mb'] = cs.frame_forms(
            '0002_mb', cs.frame_calls(mb, cfg),
            ('moving_closest', 'moving_any'), card)
        frames['0002_mb edges'] = cs.edge_forms(
            '0002_mb', mb.geom.tri_bvh, 'moving',
            cs.edge_rays(mb.geom, 1 << 16, 21, dev), card,
            strict=root == HERE)
        regs = {k: v for k, v in cs.ptxas_report(_trace_build_log()).items()
                if 'MovingTriangle' in k}
        for k, v in regs.items():
            print(f'ptxas, {k}: {"; ".join(v)} (tree {root})', flush=True)
        frames['moving registers'] = regs
    if 'spheres' in cases:
        sph = scene_mod.fit_film(cs._sphere_scene(dev), cs.W, cs.H)
        frames['spheres'] = cs.frame_forms(
            'spheres', cs.frame_calls(sph, cfg),
            ('sphere_closest', 'sphere_any'), card)
        frames['sphere edges'] = cs.sphere_edges(
            {'spheres': sph.geom, 'sphere soup': trace_mod.make_device_geometry(
                **cs._sphere_soup(1 << 16, 9), device=dev)}, card,
            strict=root == HERE and 'sphere' in cs.EXACT_KINDS)
        del sph
        regs = {k: v for k, v in cs.ptxas_report(_trace_build_log()).items()
                if 'Sphere' in k}
        for k, v in regs.items():
            print(f'ptxas, {k}: {"; ".join(v)} (tree {root})', flush=True)
        frames['sphere registers'] = regs
    if 'zoom' in cases:
        zoom = scene_mod.fit_film(cs._zoom_scene(dev), cs.W, cs.H)
        cs.zoom_tree_report(zoom.geom.tri_bvh)
        frames['zoom'], frames['zoom edges'] = cs.deep_forms(
            'zoom', zoom, cfg, card, skip=has_skip, strict=root == HERE)
        del zoom
        regs = {k: v for k, v in cs.ptxas_report(_trace_build_log()).items()
                if k.split()[0] in ('deep', 'skip')}
        for k, v in regs.items():
            print(f'ptxas, {k}: {"; ".join(v)} (tree {root})', flush=True)
        frames['deep registers'] = regs
        frames['zoom paths vs cpu'] = cs.paths_against_cpu(
            f'zoom paths (tree {root})', cs._zoom_scene, 64, 36, dev,
            gate=False, max_verts=6)
    if 'union' in cases:
        frames['union'] = union_times(cs, dev, card, root)
        regs = {k: v for k, v in cs.ptxas_report(_trace_build_log()).items()
                if k.startswith('union')}
        for k, v in regs.items():
            print(f'ptxas, {k}: {"; ".join(v)} (tree {root})', flush=True)
        frames['union registers'] = regs
    if 'edges' in cases:
        plane = scene_mod.fit_film(testing.plane_scene(device=dev), cs.W,
                                   cs.H)
        frames['plane edges'] = cs.plane_edges_phase(plane, card,
                                                     skip=has_skip)
    print(json.dumps({'device': card, 'root': root, 'calls': out,
                      'frames': frames}), flush=True)


if __name__ == '__main__':
    main()
