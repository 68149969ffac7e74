"""The readers of the program's spans and counters, on a made-up
timeline: device us under nested spans, idle time split between the
bounce loop and the rest of a progression, and no reading where the pass
holds no program span (a program without them)."""

import sys
import types

import pytest
import torch

from portbench import trace
from portbench.metrics import _spans, reader

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
SPAN_READERS = ('shade_ms', 'nee_ms', 'extend_ms', 'media_ms', 'splat_ms',
                'bounce_idle_share')


def _event(name, start, end, device=CPU, id=0, parent=None, device_us=0.0):
    return types.SimpleNamespace(
        name=name, device_type=device, time_range=types.SimpleNamespace(
            start=start, end=end), id=id, linked_correlation_id=0,
        cpu_parent=parent, device_time_total=device_us)


def _progression():
    """One call [0, 100] holding a progression [1, 99]: the camera, one
    bounce [10, 60] (intersect, media with a media span nested in it,
    shade, NEE with a media span inside, extend), the splat and the
    readback; kernels [5, 15], [32, 50] (launched at 31 in the NEE span
    by no torch op), [70, 90]."""
    call = _event(trace.SPAN, 0, 100, id=1)
    prog = _event('render.progression', 1, 99, id=2, parent=call,
                  device_us=75.0)
    bounce = _event('pt.bounce', 10, 60, id=3, parent=prog, device_us=35.0)
    media = _event('pt.media', 20, 30, id=5, parent=bounce, device_us=6.0)
    nee = _event('pt.nee', 30, 45, id=7, parent=bounce, device_us=9.0)
    spans = [
        call, prog, _event('pt.camera', 2, 10, id=8, parent=prog,
                           device_us=10.0),
        bounce, _event('pt.intersect', 10, 20, id=4, parent=bounce,
                       device_us=5.0),
        media, _event('pt.media', 22, 25, id=6, parent=media, device_us=2.0),
        _event('pt.shade', 30, 30, id=9, parent=bounce, device_us=0.0),
        nee, _event('pt.media', 35, 40, id=10, parent=nee, device_us=4.0),
        _event('pt.extend', 45, 60, id=11, parent=bounce, device_us=15.0),
        _event('pt.splat', 60, 80, id=12, parent=prog, device_us=20.0),
        _event('render.readback', 80, 99, id=13, parent=prog,
               device_us=10.0)]
    # k2 is a traversal kernel that ctypes launched inside the NEE span,
    # outside any torch op: its runtime call, and no op, holds the launch
    kernels = [_event('k1', 5, 15, CUDA, 100), _event('k2', 32, 50, CUDA, 101),
               _event('k3', 70, 90, CUDA, 102),
               _event('cudaLaunchKernel', 31, 31.5, id=101)]
    return types.SimpleNamespace(events=lambda: spans + kernels)


def _window(prof, calls=1, extra=None):
    return trace.Window(prof, calls, 100e-6, 100e-6, trace.HostPass(prof),
                        extra)


def test_device_ms_under_each_phase_outermost_media_once():
    w = _window(_progression())
    assert reader('shade_ms')(w) == 0.0
    assert reader('nee_ms')(w) == pytest.approx((9.0 + 18.0) * 1e-3)
    assert reader('extend_ms')(w) == pytest.approx(15e-3)
    assert reader('splat_ms')(w) == pytest.approx(20e-3)
    # the nested media span [22, 25] lies in one; the one in NEE counts
    assert reader('media_ms')(w) == pytest.approx((6.0 + 4.0) * 1e-3)
    w2 = _window(_progression(), calls=2)
    assert reader('media_ms')(w2) == pytest.approx(5e-3)


def test_idle_split_between_the_bounce_and_the_rest():
    # idle inside [1, 99]: [1, 5] [15, 32] [50, 70] [90, 99] = 50 us; the
    # host is in the bounce [10, 60] for [15, 32] and [50, 60] = 27 us
    w = _window(_progression())
    assert reader('bounce_idle_share')(w) == pytest.approx(27 / 50)
    assert _spans.idle_share_under(w, 'pt.splat') == pytest.approx(10 / 50)
    assert _spans.idle_share_under(w, 'render.readback') == pytest.approx(
        9 / 50)


def test_interval_arithmetic():
    a = [[0, 10], [20, 30]]
    b = [[2, 3], [5, 22], [29, 40]]
    assert _spans.subtract(a, b) == [[0, 2], [3, 5], [22, 29]]
    assert _spans.overlap(a, b) == pytest.approx(1 + 5 + 2 + 1)
    assert _spans.subtract(a, []) == a and _spans.overlap(a, []) == 0


def test_no_reading_without_program_spans():
    call = _event(trace.SPAN, 0, 10, id=1)
    op = _event('aten::mul', 1, 2, id=2, parent=call, device_us=1.0)
    prof = types.SimpleNamespace(events=lambda: [
        call, op, _event('k', 1, 3, CUDA, 100)])
    w = _window(prof)
    for name in SPAN_READERS:
        assert reader(name)(w) is None, name
    assert reader('dead_lane_share')(w) is None     # no frame handed


def test_counters_and_setup_seconds(monkeypatch):
    from corona13_tpu_torch import tracing

    def frame():
        tracing.count_bounce(torch.tensor([True, True, False, False]))
        tracing.count_bounce(torch.tensor([True, False, False, False]))
    w = _window(_progression(), extra={'frame': frame})
    assert reader('dead_lane_share')(w) == pytest.approx(5 / 8)
    monkeypatch.setattr(tracing, '_setup_s', {'scene.load': 1.5})
    assert reader('scene_load_s')(w) == 1.5
    monkeypatch.setattr(tracing, '_setup_s', {})
    assert reader('scene_load_s')(w) is None


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'corona13_tpu_torch.tracing', None)
    w = _window(_progression(), extra={'frame': lambda: None})
    assert reader('dead_lane_share')(w) is None
    assert reader('scene_load_s')(w) is None
