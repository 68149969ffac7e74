"""The port's light tracer and what it needs against the JAX package:
utils.math's sampling helpers, lights.sample_emission, camera.connect and
pdf_connect elementwise (1e-5), lt.render_sample at the same sample index
(each pixel within 1e-4 of the largest on >= 99% of pixels), the
reproducible general splat (the same bits under any permutation of its
inputs, 1e-6 of JAX's), twins of tests/test_lt.py, and the reference's
no-``time`` subpaths on a moving scene, pinned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.models import camera as jcam
from corona13_tpu.models import lights as jlights
from corona13_tpu.ops import splat as jsplat
from corona13_tpu.samplers import lt as jlt
from corona13_tpu.samplers import pt as jpt
from corona13_tpu.utils import math as jmath
from corona13_tpu_torch import convert
from corona13_tpu_torch import testing
from corona13_tpu_torch.models import camera as tcam
from corona13_tpu_torch.models import lights as tlights
from corona13_tpu_torch.ops import splat
from corona13_tpu_torch.samplers import lt
from corona13_tpu_torch.samplers import pt as pt_mod
from corona13_tpu_torch.utils import math as tmath

J, T = jnp.asarray, torch.as_tensor


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _uniforms(n, k, seed):
    return np.random.default_rng(seed).uniform(0, 1, (k, n)).astype(
        np.float32)


def test_math_helpers_match_jax():
    r1, r2 = _uniforms(4096, 2, 0)
    r2[:3] = [0.0, 1.0, 1.0 - 2 ** -24]
    for jf, tf in ((jmath.sample_cos_hemisphere, tmath.sample_cos_hemisphere),
                   (jmath.sample_sphere, tmath.sample_sphere)):
        want, got = jf(J(r1), J(r2)), tf(T(r1), T(r2))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        (got if isinstance(got, tuple) else (got,))):
            _close(b.numpy(), a)
    d, pdf = tmath.sample_cos_hemisphere(T(r1), T(r2))
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0,
                               rtol=1e-5)
    assert (d[:, 2] >= 0).all() and (pdf >= 0).all()
    g = np.random.default_rng(1)
    a = g.normal(size=(512, 3)).astype(np.float32)
    nrm = g.normal(size=(512, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    _close(tmath.norm(T(a)).numpy(), jmath.norm(J(a)))
    _close(tmath.reflect(T(a), T(nrm)).numpy(), jmath.reflect(J(a), J(nrm)),
           atol=1e-5)


def _scenes():
    return {'cornell': jtesting.cornell_scene(sphere='diffuse'),
            'plane': jtesting.assemble_scene(*testing.plane_scene_inputs())}


@pytest.mark.parametrize('name', ['cornell', 'plane'])
def test_sample_emission_matches_jax(name):
    js = _scenes()[name]
    ts = convert.scene_from_numpy(js, device='cpu')
    n = 4096
    r = _uniforms(n, 5, 2)
    lam = (380.0 + 400.0 * np.random.default_rng(3).uniform(
        0, 1, (n, 4))).astype(np.float32)
    want = jlights.sample_emission(js.lights, js.geom, js.materials,
                                   js.prim_shader, J(lam), *map(J, r))
    got = tlights.sample_emission(ts.lights, ts.geom, ts.materials,
                                  ts.prim_shader, T(lam), *map(T, r))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['prim'].numpy(), np.asarray(want['prim']))
    for k in ('pos', 'gn', 'dir', 'thr', 'pdf_pos', 'le'):
        scale = float(np.abs(np.asarray(want[k])).max())
        _close(got[k].numpy(), want[k], atol=1e-6 * scale)
    assert (np.asarray(want['thr']) > 0).any(axis=-1).mean() > 0.9
    # directions leave the emitter on its emitting side
    assert (tmath.dot(got['dir'], got['gn']) >= 0).all()


def test_connect_and_pdf_connect_match_jax():
    js = jscene.fit_film(jtesting.cornell_scene(sphere='diffuse'), 48, 32)
    ts = convert.scene_from_numpy(js, device='cpu')
    g = np.random.default_rng(4)
    n = 4096
    # points in front of, beside and behind the camera (at the origin,
    # looking down +z): many project off the film or behind the lens
    y = g.uniform([-12, -12, -6], [12, 12, 25], (n, 3)).astype(np.float32)
    y[:2] = [[0, 0, -3], [0, 0, 1e-7]]
    r1, r2, tm = _uniforms(n, 3, 5)
    want = jcam.connect(js.camera, 48, 32, J(y), J(r1), J(r2), J(tm))
    got = tcam.connect(ts.camera, 48, 32, T(y), T(r1), T(r2), T(tm))
    assert set(got) == set(want) == {'pix_i', 'pix_j', 'ap_pos', 'dir',
                                     'dist', 'cam_n', 'weight', 'valid'}
    valid = np.asarray(want['valid'])
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    assert 0.1 < valid.mean() < 0.8 and not valid[0]
    for k in ('ap_pos', 'dir', 'dist', 'cam_n', 'weight'):
        _close(got[k].numpy(), want[k], atol=1e-5)
    for k in ('pix_i', 'pix_j'):       # off the film they are unbounded
        _close(got[k].numpy()[valid], np.asarray(want[k])[valid], atol=1e-4)
    cos_ap = -np.sum(np.asarray(want['dir']) * np.asarray(want['cam_n']), -1)
    _close(tcam.pdf_connect(ts.camera, T(cos_ap)).numpy(),
           jcam.pdf_connect(js.camera, J(cos_ap)))


def _pair(sphere='diffuse', w=32, h=18, js=None):
    js = jscene.fit_film(js or jtesting.cornell_scene(sphere=sphere), w, h)
    return js, convert.scene_from_numpy(js, device='cpu')


def _images_agree(got, want, share=0.99):
    """Each pixel within 1e-4 of the largest pixel, on >= share of the
    pixels (a branch flip on a float32 near-tie moves a few)."""
    top = float(np.abs(want).max())
    assert top > 0
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= share, close.mean()


@pytest.mark.parametrize('sphere', ['diffuse', 'dielectric'])
def test_lt_matches_jax(sphere):
    js, ts = _pair(sphere)
    cfg_j = jpt.PTConfig(width=32, height=18, max_verts=6, mf=2)
    cfg_t = pt_mod.PTConfig(width=32, height=18, max_verts=6, mf=2)
    want = np.asarray(jax.jit(lambda s: jlt.render_sample(js, cfg_j, s,
                                                          batch=2))(
        jnp.uint32(3)))
    got = lt.render_sample(ts, cfg_t, 3, batch=2).numpy()
    assert got.shape == (18, 32, 3) and np.isfinite(got).all()
    _images_agree(got, want)


def test_lt_emitter_visible():
    """The light-vertex camera connection renders the emitter quad
    (tests/test_lt.py::test_lt_emitter_visible)."""
    cornell = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=48, height=32, max_verts=3, mf=2)
    fb = lt.render_sample(cornell, cfg, 0, batch=8).numpy() / 8
    top = fb[2:8, 16:32, 1].mean()
    bottom = fb[24:30, 16:32, 1].mean()
    assert top > bottom


def test_lt_matches_pt():
    """lt and pt estimate the same image (tests/test_lt.py::
    test_lt_matches_pt at its sizes and bounds)."""
    cornell = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=48, height=32, max_verts=4, mf=2,
                          use_nee=False)
    a = sum(lt.render_sample(cornell, cfg, s, batch=8) for s in range(4))
    a = a.numpy() / 32
    b = sum(pt_mod.render_sample(cornell, cfg, 100 + 24 * s, batch=24)
            for s in range(2))
    b = b.numpy() / 48
    assert np.isfinite(a).all()
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.12, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.4, corr


def _splats(n, seed, w=20, h=12):
    """Image positions (some off the image, 64 stacked on one point) and
    colours spanning five decades, 32 of them equal."""
    g = np.random.default_rng(seed)
    pi = g.uniform(-2.0, w + 2.0, n).astype(np.float32)
    pj = g.uniform(-2.0, h + 2.0, n).astype(np.float32)
    pi[:64] = pi[0]
    pj[:64] = pj[0]
    col = (10.0 ** g.uniform(-2, 3, (n, 3))).astype(np.float32)
    col[1:32] = col[0]
    return pi, pj, col


@pytest.mark.parametrize('kind', ['box', 'bilin', 'spline', 'gaussian',
                                  'blackmanharris', 'dbor'])
def test_splat_is_reproducible(kind):
    """The same bits under any permutation of the samples, and within 1e-6
    of the largest pixel of the JAX splat."""
    pi, pj, col = _splats(3000, 6)
    g = np.random.default_rng(7)

    def run(order):
        a, b, c = (T(x[order]) for x in (pi, pj, col))
        if kind == 'dbor':
            return splat.splat_dbor(torch.zeros(splat.N_DBOR, 12, 20, 3),
                                    a, b, c)
        return splat.splat(torch.zeros(12, 20, 3), a, b, c, filter_kind=kind)
    first = run(np.arange(len(pi)))
    for _ in range(3):
        assert torch.equal(run(g.permutation(len(pi))), first)
    if kind == 'dbor':
        want = np.asarray(jsplat.splat_dbor(
            jnp.zeros((jsplat.N_DBOR, 12, 20, 3)), J(pi), J(pj), J(col)))
        # log2 differs by an ulp between XLA and torch (tests/test_torch_splat)
        tol = 1e-5
    else:
        want = np.asarray(jsplat.splat(jnp.zeros((12, 20, 3)), J(pi), J(pj),
                                       J(col), filter_kind=kind))
        tol = 1e-6
    np.testing.assert_allclose(first.numpy(), want, rtol=0,
                               atol=tol * float(want.max()))


def _moving_cornell(w, h):
    """tests/test_motion.py:62-84: the cornell sphere displaced by two
    radii over a wide-open shutter."""
    sc = jscene.fit_film(jtesting.cornell_scene(sphere='diffuse'), w, h)
    still = sc.replace(camera=sc.camera.replace(
        exposure_time=jnp.float32(1.0)))
    g = sc.geom.replace(sph_c_t1=sc.geom.sph_c + J([[4.0, 0.0, 0.0]]),
                        has_motion=True)
    return still, still.replace(geom=g)


def test_lt_ignores_shutter_time_reference_defect():
    """Reference defect, reproduced: lt.py:66,105 (and bdpt.py:93,385,521)
    trace without ``time``, so on a moving scene the light paths see the
    geometry at shutter open: lt of the moving cornell equals lt of the
    same scene held still, in the JAX package and in the port, while pt
    (which passes the time) differs."""
    w, h = 32, 18
    js_still, js_mb = _moving_cornell(w, h)
    ts_still = convert.scene_from_numpy(js_still, device='cpu')
    ts_mb = convert.scene_from_numpy(js_mb, device='cpu')
    cfg_t = pt_mod.PTConfig(width=w, height=h, max_verts=4, mf=2)
    cfg_j = jpt.PTConfig(width=w, height=h, max_verts=4, mf=2)
    got = lt.render_sample(ts_mb, cfg_t, 1, batch=2)
    assert torch.equal(got, lt.render_sample(ts_still, cfg_t, 1, batch=2))
    j_mb = np.asarray(jlt.render_sample(js_mb, cfg_j, jnp.uint32(1), batch=2))
    j_still = np.asarray(jlt.render_sample(js_still, cfg_j, jnp.uint32(1),
                                           batch=2))
    np.testing.assert_array_equal(j_mb, j_still)
    _images_agree(got.numpy(), j_mb)
    p_mb = pt_mod.render_sample(ts_mb, cfg_t, 1, batch=2)
    p_still = pt_mod.render_sample(ts_still, cfg_t, 1, batch=2)
    assert not torch.equal(p_mb, p_still)
