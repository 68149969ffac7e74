"""Frame times of the port's render cells on one CUDA card, with spread.

    python3 scripts/frame_times.py [--root TREE] [--frames N] [--cells A,B]

Renders one 1024x576 progression (mf=4, NEE on) of each cell through
render.render: cornell and plane at max_verts=6, 0031_hete and
0030_subsurf at max_verts=8 with media on, the plane scene under a
1024x2048 sun envmap (sky) and under a daylight sky, 0002_mb (moving
triangles) and chip_smoke.py's hair scene (65,536 fibres: the line BVH
form) at max_verts=6 (--cells names a subset: a tree from before the
skies has only the first four).  Two warm-up frames per cell,
then N timed ones (default 8), each ending with the image on the host.
Prints seconds per frame as min / median / max with the card's name and
power limit.  --root names another checkout whose corona13_tpu_torch to
import (to compare two trees within one call on one card, run this script
once per tree, in turns); the default is this script's own tree.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1024, 576


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--frames', type=int, default=8)
    ap.add_argument('--cells', default='')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script needs a GPU')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    dev = torch.device('cuda')
    # the hair scene is chip_smoke.py's, made from a seed by this tree's
    # script with the package under test
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    golden = os.path.join(root, 'data', 'golden', 'scenes')
    load = lambda name: scene_mod.load_scene(
        os.path.join(golden, name, 'test.nra2'), device=dev)[0]
    cells = {
        'cornell': (lambda: testing.cornell_scene(sphere='diffuse',
                                                  device=dev), 6, {}),
        'plane': (lambda: testing.plane_scene(device=dev), 6, {}),
        '0031_hete': (lambda: load('0031_hete'), 8, {'media': True}),
        '0030_subsurf': (lambda: load('0030_subsurf'), 8, {'media': True}),
        'sky': (lambda: _under_envmap(testing.plane_scene(device=dev)), 6, {}),
        'daylight': (lambda: _under_daylight(testing.plane_scene(device=dev)),
                     6, {}),
        '0002_mb': (lambda: load('0002_mb'), 6, {}),
        'hair': (lambda: cs._hair_scene(dev), 6, {}),
    }
    names = [c for c in args.cells.split(',') if c] or list(cells)
    out = {}
    for name in names:
        make, max_verts, kw = cells[name]
        sc = scene_mod.fit_film(make(), W, H)
        cfg = pt_mod.PTConfig(width=W, height=H, max_verts=max_verts, mf=4,
                              use_nee=True, **kw)
        secs = []
        for i in range(2 + args.frames):
            t0 = time.perf_counter()
            render_mod.render(sc, cfg, spp=1, batch=1)
            torch.cuda.synchronize()
            if i >= 2:
                secs.append(time.perf_counter() - t0)
        out[name] = secs
        print(f'{name}: {min(secs):.4f} / {statistics.median(secs):.4f} / '
              f'{max(secs):.4f} s per frame (min / median / max of '
              f'{len(secs)}) on {card}, tree {root}', flush=True)
    print(json.dumps({'device': card, 'root': root, 'frame_s': out}),
          flush=True)


SUN_DIR = (0.3, 0.2, 0.9)


def _under_envmap(scene):
    from corona13_tpu_torch.models import envmap
    return scene.with_envmap(envmap.make_gradient_sky(
        sun_dir=SUN_DIR, sun_radiance=200.0, res=(1024, 2048)))


def _under_daylight(scene):
    import dataclasses
    from corona13_tpu_torch.models import daylight
    return dataclasses.replace(scene, has_daylight=True, daylight=daylight.build(
        SUN_DIR, 2.5, device=scene.device))


if __name__ == '__main__':
    main()
