"""The general splat's cost at a frame's width on one CUDA card.

    python3 scripts/splat_times.py [--root TREE] [--reps N]

Captures the four t = 1 camera splats of one bdpt progression of cornell
at 1024x576 (mf=4, max_verts=6: 589,824 splats each, 16 filter taps, 3
colours) as bdpt hands them to ``splat.splat``, then times, for the
tree's own ``_scatter`` and for an atomic ``index_add`` scatter on the
same inputs:
  - wall ms a call: one call between two synchronizations, median of N;
  - device ms a call: torch.profiler's kernel time over N calls, over N,
    with the kernels that take most of it and the launches a call;
and whether two runs of the four splats give the same bits.  Prints the
card's name and power limit.  --root names another checkout whose
corona13_tpu_torch to import (default: this script's own tree).
``chip_smoke.py`` uses ``capture``, ``time_calls`` and
``scatter_index_add``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1024, 576


def scatter_index_add(fb, yi, xi, contrib, keep=None):
    """The general splat's scatter before it was made reproducible: one
    atomic index_add over the flat pixel index, summing in the card's
    order, not a fixed one (``keep`` is not needed: a left-out tap adds
    0)."""
    w = fb.shape[-2]
    flat = (yi * w + xi).reshape(-1)
    out = fb.reshape(-1, 3).index_add(0, flat, contrib.reshape(-1, 3))
    return out.reshape(fb.shape)


def capture(scene, cfg, sample=7):
    """The (pix_i, pix_j, col) of the camera splats of one bdpt
    progression, as bdpt hands them to splat."""
    from corona13_tpu_torch.ops import splat as splat_mod
    from corona13_tpu_torch.samplers import bdpt
    calls, real = [], splat_mod.splat

    def record(fb, pi, pj, col, *a, **kw):
        calls.append((pi, pj, col))
        return real(fb, pi, pj, col, *a, **kw)
    splat_mod.splat = record
    try:
        with torch.no_grad():
            bdpt.render_sample(scene, cfg, sample)
    finally:
        splat_mod.splat = real
    return calls


def time_calls(run, reps=8):
    """``run(i)`` launches many kernels: the median and least wall ms of
    one call between two synchronizations, and the device ms, CUDA
    launches and heaviest kernels a call that torch.profiler sees over
    reps calls (a spin kernel queued first would not outlast the host
    here: the card's launch queue fills)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        run(0)
        walls = []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                run(i)
            torch.cuda.synchronize()
    by_name, launches = collections.Counter(), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time_total * 1e-3 / reps
            launches += 1
    return dict(wall_ms=statistics.median(walls), wall_min_ms=min(walls),
                device_ms=sum(by_name.values()), launches=launches / reps,
                top=[(name[:90], ms) for name, ms in by_name.most_common(6)])


def _measure(label, calls, reps, dev):
    from corona13_tpu_torch.ops import splat as splat_mod
    fb0 = torch.zeros((H, W, 3), device=dev)
    res = time_calls(lambda i: splat_mod.splat(fb0, *calls[i % len(calls)]),
                     reps)
    four = []
    with torch.no_grad():
        for _ in range(2):
            fb = torch.zeros((H, W, 3), device=dev)
            for c in calls:
                fb = splat_mod.splat(fb, *c)
            four.append(fb)
    res['bit_identical'] = bool(torch.equal(four[0], four[1]))
    print(f'{label}: wall {res["wall_ms"]:.3f} ms a call (median of {reps}, '
          f'min {res["wall_min_ms"]:.3f}), device {res["device_ms"]:.3f} ms a '
          f'call, {res["launches"]:.0f} launches a call; two runs of the '
          f'four splats bit-identical: {res["bit_identical"]}', flush=True)
    for name, ms in res['top']:
        print(f'    {ms:8.3f} ms  {name}', flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--reps', type=int, default=8)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script needs a GPU')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.ops import splat as splat_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    dev = torch.device('cuda')
    sc = scene_mod.fit_film(testing.cornell_scene(device=dev), W, H)
    calls = capture(sc, pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4,
                                        use_nee=True))
    n = calls[0][0].shape[0]
    print(f'general splat: {len(calls)} camera splats of a bdpt frame, '
          f'{n} splats x 16 taps x 3 colours each, on {card}, tree {root}',
          flush=True)
    out = {'tree': _measure('splat (this tree)', calls, args.reps, dev)}
    own = splat_mod._scatter
    splat_mod._scatter = scatter_index_add
    try:
        out['index_add'] = _measure('splat with an index_add scatter', calls,
                                    args.reps, dev)
    finally:
        splat_mod._scatter = own
    print(json.dumps({'device': card, 'root': root, 'splats': n, **out}),
          flush=True)


if __name__ == '__main__':
    main()
