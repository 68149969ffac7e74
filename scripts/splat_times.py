"""The general splat's cost at a frame's width on one CUDA card.

    python3 scripts/splat_times.py [--root TREE] [--reps N]

Captures the four t = 1 camera splats of one bdpt progression of cornell
at 1024x576 (mf=4, max_verts=6: 589,824 splats each, 16 filter taps, 3
colours) as bdpt hands them to ``splat.splat``, then times three ways of
splatting them (``runners``), each called explicitly: the tree's
``splat`` (on the card the kernel chain of ``ops/splat_cuda.py``), the
sort path over the plain taps, and an atomic ``index_add`` over the same
taps:
  - wall ms a call: one call between two synchronizations, median of N;
  - device ms a call: torch.profiler's kernel time over N calls, over N,
    with the kernels that take most of it, the launches and the host
    reads a call (the chain has none);
and whether two runs of the four splats give the same bits; then whether
the tree's splat gives the sort path's bits, and the share of the taps
handed that it sums (``tracing.counting()``).  Prints the card's name
and power limit.  --root names another checkout whose corona13_tpu_torch
to import (default: this script's own tree); it needs the sort path's
``_scatter_sorted`` and ``tracing.counting_on``, so a tree from before the
kernel chain is timed with that tree's own copy of this script.  The
profile is made in this fresh process: late in a long one (``chip_smoke.py``)
torch.profiler was seen to drop events.  ``chip_smoke.py`` uses
``capture``, ``runners``, ``four`` and ``bound_ms``.
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


def runners():
    """The general splat three ways, each called explicitly with (fb,
    pix_i, pix_j, col): 'splat', the tree's ``splat`` (on CUDA the kernel
    chain); 'sort', the sort path over the plain taps (``_taps``,
    ``_scatter_sorted``); 'index_add', an index_add over the same taps."""
    from corona13_tpu_torch.ops import splat as splat_mod

    def over_taps(scatter):
        def run(fb, pi, pj, col):
            for t in splat_mod._taps(fb.shape[0], fb.shape[1], pi, pj, col,
                                     'blackmanharris'):
                fb = scatter(fb, *t)
            return fb
        return run
    return {'splat': splat_mod.splat,
            'sort': over_taps(splat_mod._scatter_sorted),
            'index_add': over_taps(scatter_index_add)}


def four(run, calls, dev):
    """The captured splats one after another into a zero film on dev."""
    fb = torch.zeros((H, W, 3), device=dev)
    with torch.no_grad():
        for pi, pj, col in calls:
            fb = run(fb, pi.to(dev), pj.to(dev), col.to(dev))
    return fb


def bound_ms(splats):
    """The byte floor of one splat call into the W x H film: the
    benchmark's own (``portbench/metrics/_splat_bound.py``)."""
    from portbench.metrics._splat_bound import floor_ms
    return floor_ms(splats, W * H)


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
    launches, host reads (``aten::_local_scalar_dense`` or a device to
    host copy) and heaviest kernels a call that torch.profiler sees over
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
    by_name, launches, syncs = collections.Counter(), 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            syncs += e.name.startswith('Memcpy DtoH')
            if getattr(e, 'is_user_annotation', False):
                continue               # a span's range, not a kernel
            by_name[e.name] += e.device_time_total * 1e-3 / reps
            launches += 1
        else:
            syncs += e.name == 'aten::_local_scalar_dense'
    return dict(wall_ms=statistics.median(walls), wall_min_ms=min(walls),
                device_ms=sum(by_name.values()), launches=launches / reps,
                host_reads=syncs / reps,
                top=[(name[:90], ms) for name, ms in by_name.most_common(6)])


def _measure(label, run, calls, reps, dev):
    fb0 = torch.zeros((H, W, 3), device=dev)
    res = time_calls(lambda i: run(fb0, *calls[i % len(calls)]), reps)
    res['bit_identical'] = bool(torch.equal(four(run, calls, dev),
                                            four(run, calls, dev)))
    print(f'{label}: wall {res["wall_ms"]:.3f} ms a call (median of {reps}, '
          f'min {res["wall_min_ms"]:.3f}), device {res["device_ms"]:.3f} ms a '
          f'call, {res["launches"]:.0f} launches and {res["host_reads"]:.0f} '
          f'host reads a call; two runs of the '
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
    from corona13_tpu_torch import testing, tracing
    from corona13_tpu_torch.samplers import pt as pt_mod
    dev = torch.device('cuda')
    sc = scene_mod.fit_film(testing.cornell_scene(device=dev), W, H)
    calls = capture(sc, pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4,
                                        use_nee=True))
    n = calls[0][0].shape[0]
    print(f'general splat: {len(calls)} camera splats of a bdpt frame, '
          f'{n} splats x 16 taps x 3 colours each, on {card}, tree {root}; '
          f'bound {bound_ms(n):.4f} ms a call', flush=True)
    ways = runners()
    out = {name: _measure(name, run, calls, args.reps, dev)
           for name, run in ways.items()}
    a, b = four(ways['splat'], calls, dev), four(ways['sort'], calls, dev)
    out['bits_equal_to_sort'] = bool(torch.equal(a.view(torch.int32),
                                                 b.view(torch.int32)))
    out['largest_diff_to_sort'] = float((a - b).abs().max() / b.abs().max())
    with tracing.counting() as counters:
        four(ways['splat'], calls, dev)
    out['summed_tap_share'] = counters.summed_tap_share()
    print(f'splat against the sort path: bit-equal '
          f'{out["bits_equal_to_sort"]}, largest difference '
          f'{out["largest_diff_to_sort"]} of the largest pixel; taps summed '
          f'over taps handed {out["summed_tap_share"]}', flush=True)
    print(json.dumps({'device': card, 'root': root, 'splats': n,
                      'bound_ms': bound_ms(n), **out}), flush=True)


if __name__ == '__main__':
    main()
