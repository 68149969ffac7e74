"""Per-span device and idle ms of a benchmark cell's progressions on the
card, the checks that the program's spans and the card's kernels lie on
one clock, and what the spans and counters cost when they are on.

    python scripts/span_times.py --workload 0031_hete.progressive \
        --seed 2147483701 --calls 6 --out spans_0031.json
    python scripts/span_times.py --workload 0002_mb_bdpt.progressive_bdpt \
        --seed 2147483701 --calls 6 --out spans_bdpt.json

From the root of a checkout, on a CUDA card.  The cell's generator
(``portbench/drivers``) builds the scene and renders the calls, as the
benchmark does; then, each pass ``--calls`` calls:

- untraced, and with ``tracing.counting()`` on, in turns (off, on, on,
  off): the counters' cost a frame;
- under a profile of the card's activity alone, with the program's spans
  and with ``tracing.span`` replaced by the null context: the device
  events a frame (the spans must add none);
- under a profile of the host's ops and the card, each call inside
  ``record_function('portbench.call')`` as the benchmark's host pass,
  with and without the spans: the host pass's seconds a call.

The first two profiles are the benchmark's own passes in its order (the
card alone, then the host pass): the profiler's alignment of the card's
clock to the host's holds in a process's second profile and drifts by
milliseconds in later ones.  From that host pass, with spans: for each span name, device ms a call
under its outermost spans and the card's idle ms a call inside
``render.progression`` while the host is inside one; the card's busy ms
a call; and the checks: the top-level spans' device ms (pt's, or bdpt's
``bdpt.subpath``, ``bdpt.connect``, ``bdpt.camera``, ``bdpt.splat``, with
``splat.general`` listed beside them) against the busy ms, ``pt.intersect``
+ ``pt.nee`` (pt) against the traversal kernels' ms,
``pt.media`` against the ``aten::cumsum`` ms, every kernel starting after
the program span that launched it began, and the device events the spans
leave (user annotations).  A span's device ms counts the kernels whose
launch began inside it (``tracing.span_table``); ``reader_ms`` is what the
benchmark's reader (``portbench/metrics/_spans.py``) reads from the same
pass.  Last, one call inside ``tracing.counting()``: the dead-lane share,
the lanes alive a bounce (of pt's bounces or bdpt's subpaths), bdpt's
connection live share, the share of the general splat's taps that it
sums (``summed_tap_share``: bdpt's four camera splats), and
``tracing.launches`` by key (the traversal forms, the grid march's
'hete_sample' and 'hete_transmit', the general splat's 'splat_footprint'
and 'splat_scatter').
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from corona13_tpu_torch import tracing  # noqa: E402
from portbench import manifest, run  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.metrics import _spans  # noqa: E402
from portbench.metrics._kernels import kernel_key  # noqa: E402

TOP = ('pt.camera', 'pt.compact', 'pt.bounce', 'pt.splat', 'bdpt.subpath',
       'bdpt.connect', 'bdpt.camera', 'bdpt.splat', 'render.readback')
FRAME_SPANS = [n for n in tracing.SPAN_NAMES if n not in tracing.SETUP_SPANS]


def _sync():
    torch.cuda.synchronize()


def _no_spans():
    """tracing.span replaced by the null context, for the passes without."""
    real = tracing.span
    tracing.span = lambda name, args=None: tracing._NULL
    return lambda: setattr(tracing, 'span', real)


def _runtime(events):
    """Correlation id -> the host's runtime call that launched it."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.id: e for e in events if e.device_type != cuda
            and e.name.startswith(('cuda', 'cu'))
            and not e.name.startswith('cudnn')}


def _clock_check(events, hp):
    """Kernels of the host pass whose launch lies in a program span: how
    many, how many start before that span began, and the least lead of a
    kernel's start over its launch's start (us)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   hp.host_events if e.name in tracing.SPAN_NAMES)
    starts = [s for s, _ in spans]
    runtime = _runtime(events)
    n = early = 0
    lead = float('inf')
    for k in events:
        if (k.device_type != cuda or k.id not in runtime
                or getattr(k, 'is_user_annotation', False)):
            continue
        t = runtime[k.id].time_range.start
        lead = min(lead, k.time_range.start - t)
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i -= 1
        if i < 0:
            continue
        n += 1
        early += k.time_range.start < spans[i][0]
    return dict(kernels_in_spans=n, starting_before_their_span=early,
                least_launch_lead_us=lead)


def _annotations(events):
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in events if e.device_type == cuda and (
        e.name in tracing.SPAN_NAMES
        or getattr(e, 'is_user_annotation', False)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--calls', type=int, default=6)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('span_times: needs a CUDA card', file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function
    c = manifest.cell(args.workload)
    drv = manifest.driver(c['traffic'])(c['config'], c['traffic'], args.seed,
                                        'cuda', manifest.ROOT)
    drv.setup()
    drv.warm()
    _sync()
    n = args.calls

    def calls(wrap=None):
        t0 = time.perf_counter()
        for k in range(n):
            if wrap is None:
                drv.call(k)
            else:
                with wrap():
                    drv.call(k)
        _sync()
        return (time.perf_counter() - t0) / n

    out = dict(workload=args.workload, seed=args.seed, calls=n,
               card=run.card_line(), host=run.host_line(),
               torch=torch.__version__)
    # counters: off, on, on, off
    turns = []
    for on in (False, True, True, False):
        if on:
            with tracing.counting():
                turns.append((on, calls()))
        else:
            turns.append((on, calls()))
    out['s_a_call_counters'] = {
        'off': [s for on, s in turns if not on],
        'on': [s for on, s in turns if on]}
    # the passes in the benchmark's order first (the card alone, then the
    # host pass, which is analysed: the profiler's alignment of the card's
    # clock to the host's drifts by ms in later profiles of a process),
    # then the card alone without the spans and the host pass without,
    # without, with: with, card, without, without, with
    launches, host_s, kept = {}, {'with': [], 'without': []}, None
    for kind, spans_on in (('card', True), ('host', True), ('card', False),
                           ('host', False), ('host', False),
                           ('host', True)):
        undo = None if spans_on else _no_spans()
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if kind == 'host' else [])
        with profile(activities=acts) as prof:
            s = calls(None if kind == 'card' else
                      lambda: record_function(tr.SPAN))
        if undo:
            undo()
        tag = 'with' if spans_on else 'without'
        if kind == 'host':
            host_s[tag].append(s)
            if kept is None:
                kept = prof
            continue
        launches[tag] = dict(
            device_events=len(tr._device_events(prof)) / n,
            annotations=_annotations(prof.events()))
        if spans_on:
            card_kernels = [(e.time_range.start, e.time_range.end, e.name)
                            for e in tr._device_events(prof)]
    out['card_pass_per_call'] = launches
    out['host_pass_s_a_call'] = host_s
    events = list(kept.events())
    hp = tr.HostPass(kept)
    ctx = types.SimpleNamespace(host=hp, calls=n,
                                device_us_under=hp.device_us_under)
    busy = tr.merge((s, e) for s, e, _ in hp.kernels)
    busy_ms = sum(e - s for s, e in busy) * 1e-3 / n
    progs = tr.merge((e.time_range.start, e.time_range.end)
                     for e in _spans.spans(ctx, _spans.PROGRESSION))
    idle = _spans.subtract(progs, busy)
    exact = tracing.span_table(events)
    table = {}
    for name in FRAME_SPANS:
        found = _spans.spans(ctx, name)
        if not found:
            continue
        inside = tr.merge((e.time_range.start, e.time_range.end)
                          for e in found)
        table[name] = dict(
            device_ms=exact[name][1] * 1e-3 / n,
            reader_ms=_spans.device_ms(ctx, name),
            idle_ms=_spans.overlap(idle, inside) * 1e-3 / n,
            host_ms=exact[name][0] * 1e-3 / n,
            spans_a_call=len(found) / n)
    out['spans'] = table
    out['busy_ms_a_call'] = busy_ms
    out['idle_ms_in_progressions_a_call'] = sum(
        e - s for s, e in idle) * 1e-3 / n
    top = sum(table[t]['device_ms'] for t in TOP if t in table)
    trace_ms = sum(e - s for s, e, name in card_kernels
                   if kernel_key(name) is not None) * 1e-3 / n
    scan_ms = hp.device_us_under('aten::cumsum') * 1e-3 / n
    out['checks'] = dict(
        top_device_ms=top, top_over_busy=top / busy_ms if busy_ms else None,
        intersect_plus_nee_ms=(table['pt.intersect']['device_ms']
                               + table['pt.nee']['device_ms']
                               if 'pt.intersect' in table else None),
        trace_ms=trace_ms,
        media_ms=table.get('pt.media', {}).get('device_ms'),
        media_scan_ms=scan_ms,
        clock=_clock_check(events, hp),
        host_pass_annotations=_annotations(events))
    out['bounce_idle_share'] = _spans.idle_share_under(ctx, _spans.BOUNCE)
    before = dict(tracing.launches)
    with tracing.counting() as counters:
        drv.call(0)
    out['dead_lane_share'] = counters.dead_lane_share()
    out['connect_live_share'] = counters.connect_live_share()
    out['summed_tap_share'] = counters.summed_tap_share()
    out['alive_a_bounce'] = counters.alive()
    out['launches_a_call'] = {k: v - before[k]
                              for k, v in tracing.launches.items()
                              if v != before[k]}
    out['setup_s'] = tracing.setup_seconds()
    out['kernel_builds'] = tracing.kernel_builds()
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
