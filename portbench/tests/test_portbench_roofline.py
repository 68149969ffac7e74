"""The frozen roofline arithmetic and kernel names against chip_smoke.py's
originals, on fixed cases."""

import importlib.util
import os

import numpy as np
import pytest

from portbench import manifest
from portbench.metrics import _kernels, _roofline


@pytest.fixture(scope='module')
def cs():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_original', os.path.join(manifest.ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def geom():
    from corona13_tpu_torch.ops import trace
    r = np.random.default_rng(3)
    v0 = r.uniform(-10, 10, (300, 3)).astype(np.float32)
    e = r.uniform(-2, 2, (300, 2, 3)).astype(np.float32)
    tri = np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
    return trace.make_device_geometry(
        tri_v=tri, sph_c=r.uniform(-5, 5, (3, 3)).astype(np.float32),
        sph_r=np.ones(3, np.float32), device='cpu')


def test_bound_ms(cs, geom):
    args = (geom.tri_bvh, 589824, 530000, 1, 1, 28, 4_100_000, 910_000)
    assert _roofline._bound_ms(*args) == cs._bound_ms(*args)


@pytest.mark.parametrize('form', ['wide', 'dense'])
def test_form_bound(cs, geom, form):
    if form == 'wide':
        target, kind = geom.tri_bvh, 'tri'
    else:
        target, kind = (geom.sph_c, geom.sph_r, None), 'sphere'
    args = (target, kind, form, 589824, 530000, 28, 2_000_000, 300_000)
    assert _roofline._form_bound(*args) == cs._form_bound(*args)
    assert _roofline.PEAK_FLOP_PER_S == cs.PEAK_FLOP_PER_S == 67e12
    assert _roofline.PEAK_BYTES_PER_S == cs.PEAK_BYTES_PER_S == 3.35e12


def test_kernel_key(cs):
    names = ['void traverse_kernel<TriangleLeaf, false, false>(Args)',
             'void traverse_kernel<SphereLeaf, true>(Args)',
             'void dense_kernel<SphereLeaf, false>(Args)',
             'void deep_kernel<TriangleLeaf, true>(Args)',
             'void union_kernel<false>(Args)', 'void at::native::foo<float>()']
    for n in names:
        assert _kernels.kernel_key(n) == cs._kernel_key(n)


@pytest.mark.parametrize('name', ['0002_mb', '0031_hete'])
def test_launch_bound_of_a_captured_progression(name):
    """Every traversal launch of one progression of the program at 32x24,
    captured and bounded by the yardstick's counted plain walk (the moving
    triangles of 0002_mb, the static tree of 0031_hete)."""
    from corona13_tpu_torch import render
    from corona13_tpu_torch.samplers import pt
    from portbench import scenes
    from portbench.drivers import progressive
    from portbench.metrics._capture import capture_calls
    c = manifest.cell(f'{name}.progressive')
    keys = dict(c['config']['render'], width=32, height=24)
    sc = scenes.build(c['config']['scene'], progressive.program_side(),
                      manifest.ROOT, 'cpu', 32, 24)
    every = range(2 * keys['max_verts'])
    kept = capture_calls(
        lambda: render.render(sc, pt.PTConfig(seed=7, **keys), spp=1,
                              batch=1),
        32 * 24, {'closest_hit': every, 'any_hit': every})
    assert kept['closest_hit'] and kept['any_hit']
    kinds = {call[1] for calls in kept.values() for call in calls}
    assert kinds == ({'moving'} if name == '0002_mb' else {'tri'})
    for mode, calls in kept.items():
        for call in calls:
            ms, by = _roofline.launch_bound(mode, *call)
            assert 0 < ms < 1 and by in ('bytes', 'operations')
