"""Readings of the program's own spans and counters
(``corona13_tpu_torch/tracing.py``) in a traced window.

The program enters its spans (``record_function`` ranges) only while a
profiler records, so they appear in the window's host-traced pass
(``ctx.host``, ``portbench/trace.py``), nested under the harness's
``portbench.call`` and on the profiler's clock with the card's kernels.
The device ms under a span is the card's own time for the kernels its
host ops launched, which the host's recording does not inflate.  That
pass records the host's ops, which slows the host 1.5-1.9x a call on the
H100's host, so its idle gaps are longer than untraced ones: a share of
idle time read from it (``bounce_idle_share``) is a share within that one
pass, and an upper figure for the untraced calls.

Where the pass holds no program span, as in a program without them, a
reader returns None and the harness leaves the metric out.
"""

from __future__ import annotations

from portbench.trace import merge

PROGRESSION = 'render.progression'
BOUNCE = 'pt.bounce'


def spans(ctx, name: str) -> list:
    """The host pass's events named ``name`` that start within its calls."""
    host = ctx.host
    return [e for e in host.host_events if e.name == name
            and host.lo <= e.time_range.start <= host.hi]


def device_ms(ctx, name: str) -> float | None:
    """Device ms a call under the outermost spans ``name`` (each counted
    once where spans of that name nest), or None where there are none.
    The profiler puts a kernel under the torch op that launched it, and
    the traversal kernels, which ctypes launches outside any torch op,
    under none: the host pass names those by the innermost span that held
    their launch (``HostPass.kernels``), and they count under that span's
    name.  A kernel launched outside torch ops from a span nested in
    ``name`` would be left out; the program launches none."""
    if not ctx.calls or not spans(ctx, name):
        return None
    direct = sum(e - s for s, e, host in ctx.host.kernels if host == name)
    return (ctx.device_us_under(name) + direct) * 1e-3 / ctx.calls


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def subtract(a, b) -> list:
    """Sorted disjoint intervals a less sorted disjoint intervals b."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def overlap(a, b) -> float:
    """The length two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_under(ctx, name: str) -> float | None:
    """Of the device-idle time inside the ``render.progression`` spans of
    the host pass (their host intervals less the union of its kernels),
    the share that falls while the host is inside a span ``name``."""
    progs = merge((e.time_range.start, e.time_range.end)
                  for e in spans(ctx, PROGRESSION))
    if not progs:
        return None
    busy = merge((s, e) for s, e, _ in ctx.host.kernels)
    idle = subtract(progs, busy)
    total = _length(idle)
    if total <= 0:
        return None
    inside = merge((e.time_range.start, e.time_range.end)
                   for e in spans(ctx, name))
    return overlap(idle, inside) / total
