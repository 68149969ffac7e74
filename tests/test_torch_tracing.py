"""The port's spans and counters (``corona13_tpu_torch/tracing.py``) on
the CPU: no ``record_function`` while no profiler records, the nesting of
the named spans in a profiled progression of the 0031_hete media scene,
images bit-identical with spans and counters on and off, the alive
counter against ``pt.alive_profile``, the set-up seconds of a scene load
and the operator's ``--profile`` export."""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from corona13_tpu_torch import __main__ as cli
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import testing, tracing
from corona13_tpu_torch.ops import hete_cuda, rng_cuda, splat_cuda, trace_cuda
from corona13_tpu_torch.samplers import pt as pt_mod

_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'data', 'golden', 'scenes')
HETE = os.path.join(_SCENES, '0031_hete', 'test.nra2')
W, H = 32, 24
CFG = pt_mod.PTConfig(width=W, height=H, max_verts=4, mf=4, seed=7)
PHASES = {'pt.intersect', 'pt.media', 'pt.shade', 'pt.nee', 'pt.extend'}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process, as the other port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def hete():
    """0031_hete loaded by the port (its scene.load seconds before and
    after), its film fitted to W x H."""
    before = tracing.setup_seconds().get('scene.load', 0.0)
    sc = tscene.load_scene(HETE, device='cpu')[0]
    after = tracing.setup_seconds().get('scene.load', 0.0)
    return tscene.fit_film(sc, W, H), before, after


@pytest.fixture(scope='module')
def traced(hete):
    """One progression rendered under a CPU profile: its image and the
    profile's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fb = render_mod.render(hete[0], CFG, spp=1).fb
    return fb, list(prof.events())


def _named(events, name):
    return [e for e in events if e.name == name]


def test_span_builds_no_record_function_when_off(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError('record_function built with no profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', boom)
    with tracing.span('pt.bounce', {'depth': 0}):
        pass
    assert tracing.span('pt.shade') is tracing.span('pt.nee')
    sc = testing.cornell_scene(device='cpu')
    cfg = CFG.replace(width=8, height=6)
    res = render_mod.render(sc, cfg, spp=1, path_hist=True)
    assert res.fb.shape == (6, 8, 3) and res.path_hist[0] == 48


def test_spans_nest_as_named(traced):
    _, events = traced
    roots = _named(events, 'render.progression')
    assert len(roots) == 1
    root = roots[0]
    kids = [e.name for e in root.cpu_children if e.name in tracing.SPAN_NAMES]
    assert kids == (['pt.camera'] + ['pt.bounce'] * (CFG.max_verts - 1)
                    + ['pt.splat', 'render.readback'])
    bounces = _named(events, 'pt.bounce')
    assert len(bounces) == CFG.max_verts - 1
    for b in bounces:
        assert b.cpu_parent is root
        names = [c.name for c in b.cpu_children]
        assert set(names) == PHASES, names
        assert names[0] == 'pt.intersect' and names[-1] == 'pt.extend'
    # pt.media also inside NEE (transmittance) and the extension (stack)
    media_parents = {e.cpu_parent.name for e in _named(events, 'pt.media')}
    assert media_parents == {'pt.bounce', 'pt.nee', 'pt.extend'}
    assert not _named(events, 'pt.compact')
    # the operator's table counts the nested pt.media once in its times
    table = tracing.span_table(events)
    assert table['pt.bounce'][2] == CFG.max_verts - 1
    assert table['pt.media'][2] == 3 * (CFG.max_verts - 1)
    outer = sum(e.time_range.end - e.time_range.start
                for e in _named(events, 'pt.media'))   # none nests in another
    assert table['pt.media'][0] == pytest.approx(outer)


def test_span_table_counts_kernels_by_their_launch():
    """Device time under a span: the card's events whose launch began in
    it, those that ctypes launched outside any torch op too, nested spans
    of one name once, user annotations never."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, s, e, dev=cpu, id=0, ann=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, id=id, is_user_annotation=ann,
            time_range=types.SimpleNamespace(start=s, end=e))
    events = [ev('pt.nee', 0, 10), ev('pt.media', 2, 8), ev('pt.media', 3, 4),
              ev('aten::mul', 2.5, 2.9, id=7),
              ev('cudaLaunchKernel', 2.6, 2.7, id=1),     # by aten::mul
              ev('cudaLaunchKernel', 9, 9.1, id=2),       # by ctypes
              ev('cudaLaunchKernel', 12, 12.1, id=3),     # outside
              ev('k1', 3, 5, cuda, 1), ev('k2', 10, 16, cuda, 2),
              ev('k3', 13, 14, cuda, 3), ev('pt.nee', 3, 16, cuda, 2, True)]
    table = tracing.span_table(events)
    assert table['pt.nee'] == (10, 8, 1)
    assert table['pt.media'] == (6, 2, 2)
    assert set(table) == {'pt.nee', 'pt.media'}


def test_images_bit_identical_with_spans_and_counters(hete, traced):
    plain = render_mod.render(hete[0], CFG, spp=1).fb
    np.testing.assert_array_equal(traced[0], plain)
    with tracing.counting() as c:
        counted = render_mod.render(hete[0], CFG, spp=1).fb
    np.testing.assert_array_equal(counted, plain)
    assert len(c.alive()) == CFG.max_verts - 1


@pytest.mark.parametrize('spp,batch', [(1, 1), (2, 2)])
def test_alive_counter_equals_alive_profile(spp, batch):
    sc = testing.cornell_scene(device='cpu')
    cfg = CFG.replace(max_verts=6)
    n = W * H
    prof = pt_mod.alive_profile(sc, cfg, 0).numpy()
    with tracing.counting() as c:
        pt_mod.render_sample(sc, cfg, 0)
    assert c.alive() == prof.tolist()
    assert c.widths() == [n] * (cfg.max_verts - 1)
    assert c.dead_lane_share() == pytest.approx(1 - prof.sum() / (n * 5))
    # render(path_hist) reads the first progression of its first step
    res = render_mod.render(sc, cfg, spp=spp, batch=batch, path_hist=True)
    np.testing.assert_array_equal(res.path_hist, prof)


def test_counters_take_the_compacted_width():
    sc = testing.cornell_scene(device='cpu')
    caps = (1.0, 0.6, 0.3)
    cfg = CFG.replace(compact=caps)
    with tracing.counting() as c:
        pt_mod.render_sample(sc, cfg, 0)
    assert c.widths() == pt_mod.capacities(cfg, W * H)
    assert all(a <= w for a, w in zip(c.alive(), c.widths()))
    with tracing.counting():          # nested blocks count apart
        with tracing.counting() as inner:
            pt_mod.render_sample(sc, CFG, 0)
        assert len(inner.widths()) == CFG.max_verts - 1
    tracing.count_bounce(torch.ones(4, dtype=torch.bool))   # outside: nothing


def test_scene_load_seconds_recorded(hete):
    _, before, after = hete
    assert after > before
    # one launch registry: the bindings keep no count of their own
    assert not any(hasattr(m, 'launches')
                   for m in (trace_cuda, hete_cuda, splat_cuda, rng_cuda))
    assert {'closest', 'hete_sample', 'splat_footprint',
            'rng_uniform'} <= set(tracing.launches)
    assert tracing.kernel_builds() == 0      # no nvcc run on the CPU


def test_cli_profile_export(tmp_path, capsys):
    out = tmp_path / 'trace.json'
    rc = cli.main([os.path.join(_SCENES, '0002_mb', 'test.nra2'), '-s', '1',
                   '-w', '32', '-h', '32', '--max-verts', '3', '--device',
                   'cpu', '-x', str(tmp_path / 'r'), '--profile', str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    for name in ('render.progression', 'pt.bounce', 'pt.intersect',
                 'pt.camera', 'render.readback', 'scene.load'):
        assert any(line.startswith(name + ' ') for line in text.splitlines())
    assert 'kernel_builds: 0' in text and 'launches: none' in text
    with open(out) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'render.progression', 'pt.bounce', 'pt.splat'} <= names
