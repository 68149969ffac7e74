"""Card time of trace.intersect and trace.occluded on one CUDA card.

    python3 scripts/trace_times.py [--root TREE]

Times the two calls the sampler makes, wrapper and kernel together, on
chip_smoke.py's rays (589,824 a call) over three triangles-only BVHs: the
cornell box without its sphere, the 8198-triangle plane scene and a
2^17-triangle random soup; and on the cornell box with its sphere, whose
call adds the sphere test to the triangle walk.  intersect gets the bounce rays with a tensor
t_max (3.4e38 on every lane, as the sampler passes it), occluded the
shadow segments.  The timer is chip_smoke.py's: CUDA events behind a spin
kernel that outlasts the host's enqueueing, mean of 20 calls over two
input sets.  Prints card ms and host us per call with the card's name and
power limit.  --root names another checkout whose corona13_tpu_torch to
import: the two calls have one signature across the port's history, so
two trees are compared under one timer by running this script once per
tree, in turns, within one session on one card.
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
    root = os.path.abspath(ap.parse_args().root)
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
    dev = torch.device('cuda')
    cornell = scene_mod.fit_film(testing.cornell_scene(sphere=None, device=dev),
                                 cs.W, cs.H)
    plane = scene_mod.fit_film(testing.plane_scene(device=dev), cs.W, cs.H)
    soup = trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                          device=dev)
    ball = scene_mod.fit_film(testing.cornell_scene(sphere='diffuse',
                                                    device=dev), cs.W, cs.H)
    sets = {'cornell': (cornell.geom, [cs._ray_sets(cornell.geom, cornell, dev, s)
                                       for s in (1, 2)]),
            'cornell+sphere': (ball.geom, [cs._ray_sets(ball.geom, ball, dev, s)
                                           for s in (1, 2)]),
            'plane': (plane.geom, [cs._ray_sets(plane.geom, plane, dev, s)
                                   for s in (3, 4)]),
            'soup': (soup, [cs._soup_sets(dev, s) for s in (5, 6)])}
    t_live = torch.full((cs.N_RAYS,), cs.MAX_DIST, device=dev)
    out = {}
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
    print(json.dumps({'device': card, 'root': root, 'calls': out}), flush=True)


if __name__ == '__main__':
    main()
