"""The bdpt cell's pieces on the CPU: its modules import nothing of the
program or JAX, the manifest finds its configuration, traffic and
metrics, the reference's camera connection, light-subpath start and
general splat equal the program's, the general splat's byte floor, the
readers of its spans and counter on a made-up timeline, and runs of the
cell at 32x24, sound and with the timed path broken underneath."""

import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import manifest, run, scenes, trace
from portbench.drivers import progressive, progressive_bdpt
from portbench.metrics import _splat_bound, reader
from portbench.reference import bdpt as ref_bdpt

CELL = '0002_mb_bdpt.progressive_bdpt'
SIZE = (32, 24)
NEW = ('bdpt_subpath_ms', 'bdpt_connect_ms', 'bdpt_camera_ms',
       'general_splat_ms', 'general_splat_roofline', 'connect_live_share')
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def test_modules_import_nothing_of_the_program():
    code = ('import sys; import portbench.reference.bdpt, '
            'portbench.reference.tracer.samplers.bdpt, '
            'portbench.reference.tracer.models.camera_connect, '
            'portbench.reference.tracer.models.emission, '
            'portbench.reference.tracer.ops.splat_general, '
            'portbench.drivers.progressive_bdpt, portbench.control_bdpt; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"corona13_tpu_torch", "corona13_tpu", "jax", "jaxlib", '
            '"flax"}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == '[]'


def test_manifest_finds_the_cell():
    c = manifest.cell(CELL)
    assert c['config']['render']['sampler'] == 'bdpt'
    assert c['config']['reduced'] == [] and c['workload']['chips'] == 1
    assert manifest.driver(c['traffic']) is progressive_bdpt.Driver
    assert [m['name'] for m in c['end_to_end']] == ['setup_s', 'frame_s']
    names = [m['name'] for m in c['per_layer']]
    assert names == ['launches_per_frame', 'idle_share', 'trace_ms',
                     'trace_roofline', 'scene_load_s', *NEW]
    for m in c['per_layer']:
        assert callable(reader(m['name']))
        assert m['moves'] == ('setup_s' if m['name'] == 'scene_load_s'
                              else 'frame_s')
    assert {k: c['traffic'][k] for k in ('spp', 'batch', 'warmup', 'compare',
                                         'trace_calls')} == dict(
        spp=1, batch=1, warmup=2, compare=3, trace_calls=6)


@pytest.fixture(scope='module')
def sides():
    spec = manifest.cell(CELL)['config']['scene']
    build = lambda side: scenes.build(spec, side, manifest.ROOT, 'cpu',
                                      *SIZE)
    return build(progressive.program_side()), build(ref_bdpt.SIDE)


def test_reference_pieces_equal_the_program(sides):
    from corona13_tpu_torch.models import camera, lights
    from corona13_tpu_torch.ops import splat
    from portbench.reference.tracer.models import camera_connect, emission
    from portbench.reference.tracer.ops import splat_general
    prog, ref = sides
    g = torch.Generator().manual_seed(7)
    u = lambda *s: torch.rand(*s, generator=g)
    y = (u(4096, 3) - 0.5) * 8.0
    r1, r2 = u(4096), u(4096)
    for a, b in zip(camera.connect(prog.camera, *SIZE, y, r1, r2, 0.0)
                    .values(),
                    camera_connect.connect(ref.camera, *SIZE, y, r1, r2, 0.0)
                    .values()):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    cos = u(4096) * 2.0 - 1.0
    assert torch.equal(camera.pdf_connect(prog.camera, cos),
                       camera_connect.pdf_connect(ref.camera, cos))
    lam = 380.0 + 400.0 * u(4096, 4)
    rs = [u(4096) for _ in range(5)]
    want = lights.sample_emission(prog.lights, prog.geom, prog.materials,
                                  prog.prim_shader, lam, *rs)
    got = emission.sample_emission(ref.lights, ref.geom, ref.materials,
                                   ref.prim_shader, lam, *rs)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    fb = u(SIZE[1], SIZE[0], 3)
    pi, pj = u(4096) * SIZE[0], u(4096) * SIZE[1]
    col = u(4096, 3)
    assert torch.equal(splat.splat(fb, pi, pj, col),
                       splat_general.splat(fb, pi, pj, col))


def test_strategy_calls_and_splat_floor():
    assert progressive_bdpt.strategy_calls(6) == (8, 14)
    assert progressive_bdpt.strategy_calls(4) == (4, 5)
    n = 1920 * 1080
    assert _splat_bound.floor_ms(n, n) == pytest.approx(
        44 * n / 3.35e12 * 1e3)
    assert _splat_bound.floor_ms(n, n) == pytest.approx(0.027235, rel=1e-4)


def _event(name, start, end, device=CPU, id=0, parent=None, device_us=0.0):
    return types.SimpleNamespace(
        name=name, device_type=device, time_range=types.SimpleNamespace(
            start=start, end=end), id=id, linked_correlation_id=0,
        cpu_parent=parent, device_time_total=device_us)


def _bdpt_call():
    """One call [0, 100] holding a bdpt progression [1, 99]: a subpath
    bounce [2, 20] whose closest-hit kernel ctypes launched at 3 (no torch
    op), a connection [20, 40], a camera connection [40, 80] holding a
    general splat [50, 75], the final splat [80, 99]."""
    call = _event(trace.SPAN, 0, 100, id=1)
    prog = _event('render.progression', 1, 99, id=2, parent=call)
    cam = _event('bdpt.camera', 40, 80, id=5, parent=prog, device_us=30.0)
    spans = [call, prog,
             _event('bdpt.subpath', 2, 20, id=3, parent=prog, device_us=4.0),
             _event('bdpt.connect', 20, 40, id=4, parent=prog,
                    device_us=12.0),
             cam, _event('splat.general', 50, 75, id=6, parent=cam,
                         device_us=20.0),
             _event('bdpt.splat', 80, 99, id=7, parent=prog, device_us=9.0)]
    kernels = [_event('k', 4, 10, CUDA, 100),
               _event('cudaLaunchKernel', 3, 3.5, id=100)]
    return types.SimpleNamespace(events=lambda: spans + kernels)


def _window(prof, calls=1, extra=None):
    return trace.Window(prof, calls, 100e-6, 100e-6, trace.HostPass(prof),
                        extra)


def test_readers_on_a_made_up_timeline():
    w = _window(_bdpt_call(), extra={'lanes': 1000, 'pixels': 500})
    assert reader('bdpt_subpath_ms')(w) == pytest.approx((4.0 + 6.0) * 1e-3)
    assert reader('bdpt_connect_ms')(w) == pytest.approx(12e-3)
    assert reader('bdpt_camera_ms')(w) == pytest.approx(30e-3)
    assert reader('general_splat_ms')(w) == pytest.approx(20e-3)
    assert reader('general_splat_roofline')(w) == pytest.approx(
        100.0 * _splat_bound.floor_ms(1000, 500) / 20e-3)
    w2 = _window(_bdpt_call(), calls=2, extra={'lanes': 1000, 'pixels': 500})
    assert reader('general_splat_roofline')(w2) == pytest.approx(
        reader('general_splat_roofline')(w))
    # no program span, or no film handed: nothing to read
    call = _event(trace.SPAN, 0, 10, id=1)
    bare = types.SimpleNamespace(events=lambda: [
        call, _event('aten::mul', 1, 2, id=2, parent=call, device_us=1.0)])
    for name in NEW[:5]:
        assert reader(name)(_window(bare, extra={'lanes': 4,
                                                 'pixels': 4})) is None
    assert reader('general_splat_roofline')(_window(_bdpt_call())) is None
    assert reader('connect_live_share')(_window(bare)) is None


def test_connect_live_share_reader(monkeypatch):
    from corona13_tpu_torch import tracing

    def frame():
        tracing.count_connect(1, 2, torch.tensor([True, True, False, False]),
                              torch.tensor([True, False, False, False]))
        tracing.count_connect(1, 1, torch.tensor([True, True, True, False]),
                              torch.tensor([True, True, False, False]))
    w = _window(_bdpt_call(), extra={'frame': frame})
    assert reader('connect_live_share')(w) == pytest.approx(3 / 8)
    monkeypatch.setitem(sys.modules, 'corona13_tpu_torch.tracing', None)
    assert reader('connect_live_share')(w) is None


def _no_camera_splats(monkeypatch):
    """The t = 1 connections' splats left out."""
    from corona13_tpu_torch.ops import splat
    monkeypatch.setattr(splat, 'splat', lambda fb, *a, **kw: fb)


def _altered_answer(monkeypatch):
    """Each path's XYZ, where the splats get it, off by one part in 1e3."""
    from corona13_tpu_torch.spectral import cie
    real = cie.spectral_to_xyz
    monkeypatch.setattr(cie, 'spectral_to_xyz',
                        lambda lam, acc: real(lam, acc) * 1.001)


def test_sound_run_is_correct():
    r = run.run_cell(CELL, 2**33 + 17, 0.3, False, device='cpu', size=SIZE,
                     t_start=time.perf_counter())
    assert r['correct'] and r['attempted'] >= 1
    assert set(r['metrics']) == {'setup_s', 'frame_s'}
    assert r['checks']['pixels_off']['value'] == 0.0


@pytest.mark.parametrize('fault', [_no_camera_splats, _altered_answer])
def test_fault_reads_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run.run_cell(CELL, 4242, 0.3, False, device='cpu', size=SIZE,
                     t_start=time.perf_counter())
    assert not r['correct']
    assert r['checks']['pixels_off']['value'] > \
        r['checks']['pixels_off']['limit']


@pytest.mark.gpu
@pytest.mark.parametrize('traced', [False, True])
def test_cell_on_card(traced):
    """On the card: a short run of the cell is correct and reports its
    metrics, every new one read in the traced run."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    r = run.run_cell(CELL, 2**31 + 321, 2.0, traced,
                     t_start=time.perf_counter())
    assert r['correct'], r['checks']
    assert r['device']['platform'] == 'gpu'
    if traced:
        assert set(NEW) <= set(r['metrics'])
        assert 0 < r['metrics']['general_splat_roofline']['value'] <= 100
        assert 0 < r['metrics']['trace_roofline']['value'] <= 100
        assert 0 < r['metrics']['connect_live_share']['value'] < 1
    else:
        assert r['metrics']['frame_s']['value'] > 0
