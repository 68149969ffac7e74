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
  mb     the same for the moving-triangle launches of the 0002_mb frame;
  profile  one hair progression under torch.profiler: device ms of each
         traversal form, total device ms, CUDA launches, busy share;
  forms  chip_smoke.py's phase 3b: every form that replaces XLA's
         _traverse (moving triangles, sphere and line BVHs, the deep tree,
         the dense lists) against its plain version at 589,824 rays,
         timed, with its bound.
The timer is chip_smoke.py's: CUDA events behind a spin kernel that
outlasts the host's enqueueing, mean of 20 calls (a captured launch
that updates its carry in place gets a fresh clone each time, made
outside the timed window).  Prints card ms and host us per call with the
card's name and power limit.  --root names another checkout whose
corona13_tpu_torch to import: the calls have one signature across the
port's history, so two trees are compared under one timer by running this
script once per tree, in turns, on one card in one sitting.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    if 'forms' in cases:
        soup = sets['soup'][0] if 'soup' in sets else \
            trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                           device=dev)
        ball = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                        device=dev),
                                  cs.W, cs.H)
        forms = cs.forms_phase(dev, card, {
            'soup': (soup, cs._soup_sets(dev, 5), cs._soup_sets(dev, 6)),
            'cornell': (ball.geom, cs._ray_sets(ball.geom, ball, dev, 1),
                        cs._ray_sets(ball.geom, ball, dev, 2))})[0]
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
    print(json.dumps({'device': card, 'root': root, 'calls': out,
                      'frames': frames}), flush=True)


if __name__ == '__main__':
    main()
