"""Spans and counters of the port, on the profiler's clock.

Spans mark the layer boundaries of a progression (``render.py``,
``samplers/pt.py``, ``samplers/bdpt.py``).  While a ``torch.profiler``
profile records, ``span`` enters a ``torch.profiler.record_function`` range, so
the span lands in the profiler's timeline beside the card's kernels and
on the same clock: an idle gap of the card can then be put down to what
the host was doing.  Otherwise it returns one shared null context and
costs the check alone (about 0.2 us on an Intel Xeon host, where an
inactive ``record_function`` costs about 12 us).  The names, in their nesting:

    render.progression    one step of render.render (args: seed, sample)
      pt.camera           the camera start and the path state
      pt.compact          the wavefront's sort and bank (cfg.compact only)
      pt.bounce           one depth (args: depth), split with no gap into:
        pt.intersect      the closest hit
        pt.shade          shading.prepare and the geometric term
        pt.media          the current medium, free flight, segment
                          emission, the media pdf terms, the volume vertex
        pt.shade          the emitter and sky hit with hero MIS, the pdf
                          product
        pt.nee            area and envmap NEE with their shadow rays
        pt.extend         BSDF or phase sampling, RR, the stack, the merge
      pt.splat            spectral_to_xyz and the splat
      render.readback     the image to the host (in the render's last step)

``pt.media`` also wraps NEE's ``transmittance_scene`` (inside ``pt.nee``)
and the interior stack's push and pop (inside ``pt.extend``), so the
outermost ``pt.media`` spans hold all of the media work.

A bdpt progression (``render.render`` with ``cfg.sampler == 'bdpt'``,
``samplers/bdpt.py``) holds, inside ``render.progression``, sibling
spans none of which nests in another ``bdpt.*`` span:

    bdpt.subpath          the subpaths' starts (camera and emission
                          samples) and each eye and light bounce
    bdpt.connect          one strategy (args: s, t): the s = 0 emitter
                          hits, or an s >= 1, t >= 2 connection with its
                          shadow ray and MIS
    bdpt.camera           one t = 1 connection (args: s): its shadow ray,
                          MIS and splat, with
      splat.general       ``ops/splat.splat`` (wherever it runs: lt,
                          ptlt, kmlt, vmlt and the sharded frame too)
    bdpt.splat            spectral_to_xyz and the pixel-aligned splat

Set-up spans (``setup_span``: ``SETUP_SPANS``, the scene's load and the
kernel libraries' builds) run once a process: they always keep their
host seconds in memory, by name (``setup_seconds``), and are
``record_function`` ranges as well while a profiler records.
``kernel_builds`` counts the nvcc runs.

Counters are kept only inside ``counting()``: for each bounce (pt's, and
each bounce of bdpt's subpaths), the lanes alive when it starts and the
wavefront's width; for each bdpt connection that has a shadow ray (s >=
1), the lanes that may connect before the visibility test and the lanes
still connected after it; for each general splat (``ops/splat.py``'s
scatters), the taps summed (on the film and not +-0.0 in all three
colours: the taps the card's binned sum keeps) and the taps it was
handed.  They are device tensors that are read when asked for, so
nothing synchronises inside a frame.  Off, they cost one check a bounce,
connection or splat; on, one reduction (two a connection, a copy a
splat on the card).

``launches`` counts the hand-written kernels' launches by key, as
``ops/cuda_lib.launch`` makes them (``count_launch``): the traversal's per
form, the grid march's by mode, the general splat's chains by entry and
the counter RNG's draws ('rng_uniform').
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

SPAN_NAMES = ('render.progression', 'render.readback', 'pt.camera',
              'pt.compact', 'pt.bounce', 'pt.intersect', 'pt.media',
              'pt.shade', 'pt.nee', 'pt.extend', 'pt.splat', 'bdpt.subpath',
              'bdpt.connect', 'bdpt.camera', 'bdpt.splat', 'splat.general',
              'scene.load', 'trace_cuda.build', 'hete_cuda.build',
              'splat_cuda.build', 'rng_cuda.build')
SETUP_SPANS = ('scene.load', 'trace_cuda.build', 'hete_cuda.build',
               'splat_cuda.build', 'rng_cuda.build')

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_setup_s = collections.defaultdict(float)   # set-up span -> host seconds
_builds = 0
_counters = None                            # the innermost counting() block

# launches of the hand-written kernels (ops/cuda_lib.launch), by key: the
# traversal's forms, each closest-hit and any-hit, its union walk
# ('counters') and per-ray walks (ops/trace_cuda.py); the grid march by
# mode (ops/hete_cuda.py); the general splat's chains (ops/splat_cuda.py);
# the counter RNG's draws (ops/rng_cuda.py)
launches = {k: 0 for k in (
    'closest', 'any', 'counters',
    *(f'{f}_{m}' for f in ('moving', 'sphere', 'line', 'deep', 'skip',
                           'dense_sphere', 'dense_line')
      for m in ('closest', 'any')),
    'tri_counters', 'line_counters', 'hete_sample', 'hete_transmit',
    'splat_scatter', 'splat_footprint', 'rng_uniform')}


def span(name: str, args: dict | None = None):
    """A ``record_function(name)`` range while a profiler records, with
    ``args`` as its ``k=v`` text; else the shared null context."""
    if not _recording():
        return _NULL
    text = None if args is None else ' '.join(
        f'{k}={v}' for k, v in args.items())
    return torch.profiler.record_function(name, text)


@contextlib.contextmanager
def setup_span(name: str):
    """A one-shot set-up span: its host seconds are added to
    ``setup_seconds()[name]`` whether or not a profiler records.  Also a
    decorator."""
    t0 = time.perf_counter()
    with span(name):
        yield
    _setup_s[name] += time.perf_counter() - t0


def setup_seconds() -> dict:
    """Host seconds of each set-up span so far in this process."""
    return dict(_setup_s)


def note_kernel_build():
    """Count one nvcc run (``cuda_lib.compile_library``)."""
    global _builds
    _builds += 1


def kernel_builds() -> int:
    """nvcc runs of ``cuda_lib.compile_library`` in this process."""
    return _builds


def count_launch(key: str):
    """Count one launch of a hand-written kernel under ``key``, one of
    ``launches``' keys."""
    launches[key] += 1


class Counters:
    """The per-bounce counts of one ``counting()`` block, in the order of
    the bounces (several progressions follow one another)."""

    def __init__(self, lanes: int | None = None):
        self.lanes = lanes
        self._bounces = []      # (alive lanes, a 0-d device tensor; width)
        self._connects = []     # (s, t, can, live: 0-d device tensors; lanes)
        self._splats = []       # (taps summed, a 0-d device tensor; handed)

    def bounce(self, alive):
        if self.lanes is not None:
            alive = alive[:self.lanes]
        self._bounces.append((alive.sum(), alive.shape[0]))

    def alive(self) -> list[int]:
        """Lanes alive at the start of each bounce (one transfer)."""
        if not self._bounces:
            return []
        return torch.stack([a for a, _ in self._bounces]).cpu().tolist()

    def widths(self) -> list[int]:
        """The wavefront's width at each bounce: n dense, the capacity
        under cfg.compact."""
        return [w for _, w in self._bounces]

    def dead_lane_share(self) -> float | None:
        """1 - the lanes alive over the lanes run, over every bounce."""
        run = sum(self.widths())
        return 1.0 - sum(self.alive()) / run if run else None

    def connect(self, s: int, t: int, can, live):
        self._connects.append((s, t, can.sum(), live.sum(), can.shape[0]))

    def connections(self) -> list[tuple]:
        """(s, t, lanes that may connect, lanes connected, lanes) of each
        bdpt connection in order (one transfer)."""
        if not self._connects:
            return []
        counts = torch.stack([torch.stack([c, v]) for _, _, c, v, _
                              in self._connects]).cpu().tolist()
        return [(s, t, c, v, n) for (s, t, _, _, n), (c, v)
                in zip(self._connects, counts)]

    def connect_live_share(self) -> float | None:
        """The lanes still connected after the visibility test over the
        lanes of every connection pass computed: the share of the dense
        connection passes that does useful work."""
        rows = self.connections()
        run = sum(n for *_, n in rows)
        return sum(v for _, _, _, v, _ in rows) / run if run else None

    def splat(self, summed, handed: int):
        self._splats.append((summed.to(torch.int64), handed))

    def splat_taps(self) -> list[tuple]:
        """(taps summed, taps handed) of each general splat's scatter in
        order (one transfer)."""
        if not self._splats:
            return []
        summed = torch.stack([s for s, _ in self._splats]).cpu().tolist()
        return [(s, h) for s, (_, h) in zip(summed, self._splats)]

    def summed_tap_share(self) -> float | None:
        """The taps summed over the taps handed, over every general splat:
        the share of the plain path's scatter that adds something."""
        rows = self.splat_taps()
        handed = sum(h for _, h in rows)
        return sum(s for s, _ in rows) / handed if handed else None


@contextlib.contextmanager
def counting(lanes: int | None = None):
    """Count every bounce inside the block; yields the ``Counters``.
    ``lanes``: count only the first ``lanes`` lanes of a dense wavefront
    (the first progression of a batch)."""
    global _counters
    outer, _counters = _counters, Counters(lanes)
    try:
        yield _counters
    finally:
        _counters = outer


def count_bounce(alive):
    """Record a bounce's alive mask inside ``counting()``; else nothing."""
    if _counters is not None:
        _counters.bounce(alive)


def count_connect(s: int, t: int, can, live):
    """Record a bdpt connection's masks (before and after the visibility
    test) inside ``counting()``; else nothing."""
    if _counters is not None:
        _counters.connect(s, t, can, live)


def counting_on() -> bool:
    """Whether a ``counting()`` block is open."""
    return _counters is not None


def count_splat(summed, handed: int):
    """Record a general splat's scatter inside ``counting()`` (the taps
    summed, a 0-d device tensor, copied; the taps handed); else
    nothing."""
    if _counters is not None:
        _counters.splat(summed, handed)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_table(events) -> dict:
    """{span name: (host us, device us, calls)} of the program's spans
    among a profile's events.  Device us: the card's events whose launch
    (the runtime call of the same correlation id) began inside a span of
    that name, which counts the traversal kernels that ctypes launches
    outside any torch op too; nested spans of one name count once."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(events)
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == cpu and e.name.startswith(('cuda', 'cu'))}
    kernels = sorted(
        (launch[e.id], e.time_range.end - e.time_range.start)
        for e in events if e.device_type != cpu and e.id in launch
        and not getattr(e, 'is_user_annotation', False))
    starts = [t for t, _ in kernels]
    cum = [0.0]
    for _, us in kernels:
        cum.append(cum[-1] + us)
    rows = {}
    for name in SPAN_NAMES:
        mine = [e for e in events if e.name == name and e.device_type == cpu]
        if not mine:
            continue
        outer = _merged((e.time_range.start, e.time_range.end) for e in mine)
        dev = sum(cum[bisect.bisect_right(starts, e)]
                  - cum[bisect.bisect_left(starts, s)] for s, e in outer)
        rows[name] = (sum(e - s for s, e in outer), dev, len(mine))
    return rows


def report(events) -> list[str]:
    """The operator's lines of a profile: one a span name (host ms, device
    ms, calls, in SPAN_NAMES order), the set-up seconds, the nvcc runs and
    the hand-written kernels' launches by key."""
    rows = span_table(events)
    out = [f'{n:20s} host {rows[n][0] / 1e3:10.3f} ms  device '
           f'{rows[n][1] / 1e3:10.3f} ms  calls {rows[n][2]}'
           for n in SPAN_NAMES if n in rows]
    out.append('set-up s: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in sorted(setup_seconds().items())))
    out.append(f'kernel_builds: {kernel_builds()}')
    out.append('launches: ' + (', '.join(
        f'{k} {v}' for k, v in launches.items() if v) or 'none'))
    return out
