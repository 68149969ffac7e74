"""Reduction of one traced window (``torch.profiler`` over the cell's own
calls) to the numbers the per-layer readers and the result line take.

The traced run makes the same calls three times.  Untraced first: the
host clock's seconds from the first call's start to the card's end of the
last (``wall_s``).  Then with the card's activity alone traced: the
window (``window_s``, by the same clock) and the device's busy time, the
union of the intervals in which a kernel, copy or set ran on the card.
Tracing the card still slows the host's launches (by 5-8 us a launch on
the H100's host), so the idle share is the busy time over the untraced
seconds.  Then with the host's ops recorded too, each call inside a
``record_function(SPAN)``: that pass says which host op launched each
kernel, and so what the host was doing in each idle gap, on a host that
the recording slows further.
"""

from __future__ import annotations

import bisect
import collections

import torch

SPAN = 'portbench.call'
NAME_CHARS = 160     # a kernel's name in the breakdown, cut to this length


def _device_time_us(e) -> float:
    """An event's device time in us under either name torch has used."""
    for attr in ('device_time_total', 'cuda_time_total'):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def merge(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def idle_gaps(kernels, lo, hi):
    """The stretches of [lo, hi] with nothing on the device, each named by
    what the host launched to end it: [(name, length)].  kernels: (start,
    end, name of the host op that launched it) tuples."""
    ks = sorted(kernels)
    gaps, cursor = [], lo
    for s, e, host in ks:
        if s > cursor and cursor < hi:
            gaps.append((host, min(s, hi) - cursor))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append(('after the last kernel', hi - cursor))
    return gaps


def _launchers(host_events):
    """A function naming, for a device event, the innermost torch op that
    was running on the host when its launch (the runtime call of the same
    correlation id) began; 'no torch op' where none was, as for the
    kernels that ctypes launches."""
    runtime, ops = {}, []
    for e in host_events:
        if e.name.startswith(('cuda', 'cu')) and not e.name.startswith(
                'cudnn'):
            runtime[e.id] = e
        elif e.name != SPAN and not e.name.startswith('ProfilerStep'):
            ops.append((e.time_range.start, e.time_range.end, e.name))
    ops.sort()
    starts = [s for s, _, _ in ops]

    def name(e):
        call = runtime.get(e.id)
        if call is None:
            return 'no torch op'
        t = call.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:          # the latest-starting op that holds t
            s, end, op = ops[i]
            if end >= t:
                return op
            i -= 1
        return 'no torch op'
    return name


def _device_events(prof):
    """The card's events of a profile: kernels, copies and sets (the
    device's copy of a record_function range is no device work)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and e.name != SPAN
            and not getattr(e, 'is_user_annotation', False)]


class HostPass:
    """The traced calls again, under a profile of host and card activity,
    each call inside a ``record_function(SPAN)``: which host op launched
    each kernel, and so what the host was doing in each idle gap.
    Recording the host's ops slows the host (1.5-1.9x a call on the H100's
    host), so its gaps are longer than the window's: they rank the host's
    work, and no busy or idle figure is read from them."""

    def __init__(self, prof):
        events = list(prof.events())
        cuda = torch.autograd.DeviceType.CUDA
        self.host_events = [e for e in events if e.device_type != cuda]
        spans = [e for e in self.host_events if e.name == SPAN]
        if not spans:
            raise RuntimeError('the host-traced pass holds no call span')
        self.lo = min(e.time_range.start for e in spans)
        self.hi = max(e.time_range.end for e in spans)
        host_of = _launchers(self.host_events)
        self.kernels = [(e.time_range.start, e.time_range.end, host_of(e))
                        for e in _device_events(prof)
                        if e.time_range.end > self.lo
                        and e.time_range.start < self.hi]

    def device_us_under(self, op_name: str) -> float:
        """Device us of the kernels that the host ops named op_name launched
        (with their children), each outermost such op counted once."""
        total = 0.0
        for e in self.host_events:
            if e.name != op_name or not self.lo <= e.time_range.start <= self.hi:
                continue
            p = e.cpu_parent
            while p is not None and p.name != op_name:
                p = p.cpu_parent
            if p is None:
                total += _device_time_us(e)
        return total

    def idle_gaps(self):
        return idle_gaps(self.kernels, self.lo, self.hi)


class Window:
    """A traced window: ``calls`` calls into the program under a profile
    of the card's activity alone (``prof``), timed by the host's clock
    from the first call's start to the card's end of the last
    (``window_s``); every device event of the profile lies in it.
    ``wall_s``: the same calls' seconds untraced.  ``host``, a
    ``HostPass`` of the same calls again, attributes device work to host
    ops.  ``extra`` carries what a reader needs from the harness besides
    the trace (the driver's own hooks)."""

    def __init__(self, prof, calls: int, window_s: float, wall_s: float,
                 host: HostPass, extra: dict | None = None):
        self.calls, self.window_s, self.wall_s = calls, window_s, wall_s
        self.host = host
        self.extra = extra or {}
        self.kernels = [(e.time_range.start, e.time_range.end, e.name)
                        for e in _device_events(prof)]

    @property
    def busy_s(self) -> float:
        """Seconds in which anything ran on the card: the union of the
        window's device intervals."""
        return sum(e - s for s, e in merge(
            (s, e) for s, e, _ in self.kernels)) * 1e-6

    @property
    def launches(self) -> int:
        """Device events in the window (kernels, copies, sets), as
        ``scripts/frame_times.py`` ``_launches`` counts a frame's."""
        return len(self.kernels)

    def device_us_where(self, pred) -> float:
        """Device us of the window's kernels whose name satisfies pred."""
        return sum(e - s for s, e, name in self.kernels if pred(name))

    def device_us_under(self, op_name: str) -> float:
        """Device us under the host ops named op_name, from the host pass."""
        return self.host.device_us_under(op_name)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        longest idle gaps of the host pass by the host op that ended them,
        in seconds."""
        ops = collections.Counter()
        for s, e, name in self.kernels:
            ops[name[:NAME_CHARS]] += (e - s) * 1e-6
        gaps = collections.Counter()
        for host, length in self.host.idle_gaps():
            gaps[host] += length * 1e-6
        return {'device_ops': [[k, v] for k, v in ops.most_common(top)],
                'idle_gaps': [[k, v] for k, v in gaps.most_common(top)]}


def profile_kernels(fn):
    """Run fn under torch.profiler (the card's activity alone) and return
    its device events as (name, us) pairs; none without a card."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events() if e.device_type == cuda]
