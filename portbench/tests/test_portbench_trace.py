"""The reduction of a traced window, on a made-up timeline."""

import types

import pytest
import torch

from portbench import trace
from portbench.metrics import reader

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CPU, id=0, linked=0, parent=None,
           device_us=0.0):
    return types.SimpleNamespace(
        name=name, device_type=device, time_range=types.SimpleNamespace(
            start=start, end=end), id=id, linked_correlation_id=linked,
        cpu_parent=parent, device_time_total=device_us)


def _kernels():
    """k1 [10, 30] and a traversal kernel [20, 40] (overlapping), k3
    [60, 70], launched by op_a, op_b and op_c (correlation ids 100-102),
    and the device's copy of a span, which is no work."""
    return [_event('k1', 10, 30, CUDA, 100, 10),
            _event('traverse_kernel<TriangleLeaf, false>', 20, 40, CUDA,
                   101, 11),
            _event('k3', 60, 70, CUDA, 102, 12),
            _event(trace.SPAN, 0, 50, CUDA, 104, 1)]


def _host_pass():
    """The same calls again with the host recorded: spans over 0-100 us,
    the host ops, the runtime calls that launched k1 and k3, and one
    kernel outside the spans."""
    span1 = _event(trace.SPAN, 0, 50, id=1)
    span2 = _event(trace.SPAN, 50, 100, id=2)
    scan = _event('aten::cumsum', 55, 58, id=5, parent=span2, device_us=10.0)
    inner = _event('aten::cumsum', 56, 57, id=6, parent=scan, device_us=10.0)
    ops = [_event('op_a', 5, 9, id=10, parent=span1),
           _event('op_b', 12, 14, id=11, parent=span1),
           _event('op_c', 54, 59, id=12, parent=span2)]
    calls = [_event('cudaLaunchKernel', 6, 7, id=100),
             _event('cudaLaunchKernel', 58.5, 58.7, id=102)]
    outside = _event('k4', 150, 160, CUDA, 103, 0)
    prof = types.SimpleNamespace(events=lambda: [
        span1, span2, scan, inner, *ops, *calls, *_kernels(), outside])
    return trace.HostPass(prof)


def _window():
    """Two calls: 100 us untraced, a 120 us window traced with the card
    alone."""
    prof = types.SimpleNamespace(events=_kernels)
    return trace.Window(prof, 2, 120e-6, 100e-6, _host_pass())


def test_merge():
    assert trace.merge([(5, 8), (0, 2), (1, 3), (8, 9)]) == [[0, 3], [5, 9]]


def test_idle_share_overlapping_and_gapped():
    w = _window()
    assert w.window_s == pytest.approx(120e-6)
    assert w.busy_s == pytest.approx(40e-6)
    assert w.launches == 3
    assert reader('idle_share')(w) == pytest.approx(0.6)
    assert reader('launches_per_frame')(w) == pytest.approx(1.5)


def test_gaps_named_by_the_launching_op():
    w = _window()
    gaps = dict((k, v) for k, v in w.breakdown()['idle_gaps'])
    # k3's launch began at 58.5, inside op_c (54-59) and not in the
    # scan (55-58, which ended at its start): the innermost holding op
    assert gaps == pytest.approx({'op_a': 10e-6, 'op_c': 20e-6,
                                  'after the last kernel': 30e-6})
    ops = dict((k, v) for k, v in w.breakdown()['device_ops'])
    assert ops['k1'] == pytest.approx(20e-6)


def test_device_time_under_an_op_counts_the_outermost_once():
    w = _window()
    assert w.device_us_under('aten::cumsum') == 10.0
    assert reader('media_scan_ms')(w) == pytest.approx(10e-3 / 2)
    assert reader('trace_ms')(w) == pytest.approx(20e-3 / 2)


def test_readers_read_nothing_from_an_empty_window():
    span = _event(trace.SPAN, 0, 10)
    empty = types.SimpleNamespace(events=lambda: [span])
    w = trace.Window(empty, 1, 10e-6, 10e-6, trace.HostPass(empty))
    for name in ('idle_share', 'launches_per_frame', 'media_scan_ms',
                 'trace_ms', 'trace_roofline'):
        assert reader(name)(w) is None
