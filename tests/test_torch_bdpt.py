"""The port's bidirectional path tracer against the JAX package:
``_connectable`` elementwise, ``_trace_subpath`` record by record (every
field of every vertex, eye and light, driven by the same random streams:
>= 99% of lanes within 1e-5 on the box; with the dielectric sphere 98% at
1e-5 and 99% at 1e-4), ``render_sample(only=(s, t))`` for each of
the 8 strategies of max_verts=4 (each pixel within 1e-4 of the largest on
>= 99% of pixels), absorbing media with the warning, and twins of
tests/test_bdpt.py (partition, t = 1 share, specular scene, bdpt ~ pt,
absorbing media ~ ptdl)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.models import camera as jcam
from corona13_tpu.models import lights as jlights
from corona13_tpu.ops import rng as jrng
from corona13_tpu.samplers import bdpt as jbdpt
from corona13_tpu.samplers import pt as jpt
from corona13_tpu.spectral import cie as jcie
from corona13_tpu.utils.math import ray_offset as jray_offset
from corona13_tpu_torch import convert
from corona13_tpu_torch.ops import rng as trng
from corona13_tpu_torch.samplers import bdpt
from corona13_tpu_torch.samplers import bdpt1
from corona13_tpu_torch.samplers import pt as pt_mod

J, T = jnp.asarray, torch.as_tensor
W, H = 24, 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(sphere='diffuse', w=W, h=H, js=None):
    js = jscene.fit_film(js or jtesting.cornell_scene(sphere=sphere), w, h)
    return js, convert.scene_from_numpy(js, device='cpu')


def _cfgs(**kw):
    kw = dict(dict(width=W, height=H, max_verts=4, mf=2, use_nee=True,
                   rr_start=99), **kw)
    return jpt.PTConfig(**kw), pt_mod.PTConfig(**kw)


def _images_agree(got, want, share=0.99):
    """Each pixel within 1e-4 of the largest pixel, on >= share of the
    pixels (a branch flip on a float32 near-tie moves a few)."""
    top = float(np.abs(want).max())
    assert top > 0
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= share, close.mean()


def test_connectable_matches_jax():
    g = np.random.default_rng(0)
    kind = g.integers(0, 6, 4096)
    rough = g.choice([0.0, 1e-3, 1.001e-3, 0.3, 1.0], 4096).astype(np.float32)
    want = jbdpt._connectable(types.SimpleNamespace(kind=J(kind.astype(
        np.int32)), roughness=J(rough)))
    got = bdpt._connectable(types.SimpleNamespace(kind=T(kind),
                                                  roughness=T(rough)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.3 < got.float().mean() < 0.9


_SP_FIELDS = ('kind', 'rd', 'rg', 'em', 'roughness', 'eta_ratio',
              'fresnel_eta', 'fresnel_k', 'n', 'gn', 'inside')
_REC_FIELDS = ('x', 'd_in', 'thr', 'pdf_fwd_a', 'pdf_rev_a', 'g_rev',
               'valid', 'connectable', 'prim', 'med')


# the bars: (rtol, share of lanes) per scene.  On the box every field of
# every lane agrees (1.0000 at each vertex: held at 99.9%).  On the
# dielectric sphere a hit's t comes from b*b - c, which cancels at grazing
# incidence, and this module runs the JAX package in its own process,
# where XLA contracts multiply-adds into FMA: 1.3-1.6% of the lanes carry
# a normal off by 1e-5 to 4e-5 into the rest of their subpath (at 1e-5 the
# eye subpath's vertices read 0.9844-0.9922, the light's 0.9870-0.9974),
# and at a dielectric it may flip the reflect-or-refract pick (at 1e-4:
# 0.9948-1.0000).  The root is not the cause (the port's is correctly
# rounded, and these shares did not move with it): with
# XLA_FLAGS=--xla_cpu_max_isa=AVX (no FMA) they read 0.9974 or more.  The
# shares are printed (pytest -s)
_BARS = {None: ((1e-5, 0.999),),
         'dielectric': ((1e-5, 0.98), (1e-4, 0.99))}


@pytest.mark.parametrize('sphere', [None, 'dielectric'])
@pytest.mark.parametrize('side', ['eye', 'light'])
def test_trace_subpath_matches_jax(side, sphere):
    """Both packages' _trace_subpath from the same start (computed once,
    by the JAX package) with the same random streams: every field of every
    vertex record within rtol (atol: 1e-6 of the field's largest value) on
    the lanes the bar asks for; ids and flags equal on the same lanes."""
    js, ts = _pair(sphere)
    cfg_j, cfg_t = _cfgs(max_verts=6)
    n = W * H
    pix = np.arange(n, dtype=np.uint32)
    seed = cfg_j.seed + (0x9e37 if side == 'light' else 0)

    def rnd_j(dim, salt=0):
        return jrng.sample_dim('rand', J(pix), jnp.uint32(3),
                               dim + 101 * salt, seed)

    def rnd_t(dim, salt=0):
        return trng.sample_dim('rand', T(pix.astype(np.int64)), 3,
                               int(dim) + 101 * salt, seed)
    lam, _ = jcie.sample_lambda_hero(rnd_j(jrng.Dim.LAMBDA), 2)
    if side == 'eye':
        time = rnd_j(jrng.Dim.TIME) * 0.0
        pi = (J(pix) % W).astype(jnp.float32) + rnd_j(jrng.Dim.IMAGE_X)
        pj = (J(pix) // W).astype(jnp.float32) + rnd_j(jrng.Dim.IMAGE_Y)
        org, d0, thr, pdf = jcam.sample(js.camera, W, H, pi, pj,
                                        rnd_j(jrng.Dim.APERTURE_X),
                                        rnd_j(jrng.Dim.APERTURE_Y), time)
        start = (org, d0, jnp.broadcast_to(thr[:, None], (n, 2)),
                 pdf[:, None], jnp.broadcast_to(
                     jcam.cam_frame(js.camera, time)[2], (n, 3)),
                 jnp.full((n,), -1, jnp.int32))
        steps = 5
    else:
        em = jlights.sample_emission(
            js.lights, js.geom, js.materials, js.prim_shader, lam,
            *(rnd_j(d) for d in (jrng.Dim.LIGHTSOURCE, jrng.Dim.LIGHT_X,
                                 jrng.Dim.LIGHT_Y, jrng.Dim.EDF_X,
                                 jrng.Dim.EDF_Y)))
        start = (jray_offset(em['pos'], em['dir']), em['dir'], em['thr'],
                 jnp.full((n, 1), 1.0 / np.pi), em['gn'], em['prim'])
        steps = 3
    want = jax.jit(lambda: jbdpt._trace_subpath(
        js, cfg_j, lam, *start, steps, rnd_j, salt_base=1))()
    tstart = [T(np.array(a)) for a in start]
    tstart[5] = tstart[5].to(torch.int64)
    got = bdpt._trace_subpath(ts, cfg_t, T(np.asarray(lam)), *tstart, steps,
                              rnd_t, salt_base=1)
    assert isinstance(got, list) and len(got) == steps
    assert set(got[0]) == set(_REC_FIELDS) | {'sp'}
    for i, rec in enumerate(got):
        wr = jbdpt._at(want, i)
        pairs = [(getattr(rec['sp'], f), getattr(wr['sp'], f))
                 for f in _SP_FIELDS] + [(rec[f], wr[f]) for f in _REC_FIELDS]
        for rtol, share in _BARS[sphere]:
            ok = np.ones(n, bool)
            for a, b in pairs:
                a, b = a.numpy(), np.asarray(b)
                if b.dtype.kind == 'f':
                    scale = float(np.abs(b[np.isfinite(b)]).max(initial=0))
                    same = np.isclose(a, b, rtol=rtol, atol=1e-6 * scale)
                else:
                    same = a == b
                ok &= same.reshape(n, -1).all(axis=-1)
            print(f'{side} {sphere} vertex {i} rtol {rtol}: lanes '
                  f'{ok.mean():.4f} (bar {share})')
            assert ok.mean() >= share, (side, i, rtol, ok.mean())
        assert np.asarray(wr['valid']).mean() > 0.05


_STRATEGIES = bdpt1.strategies(pt_mod.PTConfig(max_verts=4))


def test_eight_strategies():
    assert len(_STRATEGIES) == 8


@pytest.mark.parametrize('st', _STRATEGIES, ids=lambda st: f's{st[0]}t{st[1]}')
def test_strategy_matches_jax(st):
    js, ts = _pair('diffuse')
    cfg_j, cfg_t = _cfgs()
    want = np.asarray(jax.jit(lambda s: jbdpt.render_sample(
        js, cfg_j, s, only=st))(jnp.uint32(3)))
    got = bdpt.render_sample(ts, cfg_t, 3, only=st).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    _images_agree(got, want)


@pytest.fixture(scope='module')
def cornell():
    return _pair('diffuse')[1]


def test_bdpt_strategy_partition(cornell):
    """The per-strategy renders (only=(s, t), full-set MIS denominators)
    sum to the full render (tests/test_bdpt.py::
    test_bdpt_strategy_partition)."""
    cfg = _cfgs()[1]
    full = bdpt.render_sample(cornell, cfg, 3).numpy()
    acc = sum(bdpt.render_sample(cornell, cfg, 3, only=st).numpy()
              for st in _STRATEGIES)
    np.testing.assert_allclose(acc, full, rtol=1e-4, atol=1e-5)


def test_bdpt_t1_share_not_collapsed(cornell):
    """The t = 1 camera splats carry a real share of the full estimator
    (tests/test_bdpt.py::test_bdpt_t1_share_not_collapsed)."""
    cfg = _cfgs()[1]
    full = t1 = 0.0
    for i in range(4):
        full = full + bdpt.render_sample(cornell, cfg, i).sum()
        for s in (1, 2):
            t1 = t1 + bdpt.render_sample(cornell, cfg, i, only=(s, 1)).sum()
    share = float(t1 / full)
    assert 0.02 < share < 0.9, share


def test_bdpt_batch_copies_repeat_reference_defect(cornell):
    """Reference defect, reproduced: bdpt.py:206-208 tiles the pixel ids
    over ``batch`` with one sample index, so the batch copies trace the
    same paths and a batch of 2 is twice a batch of 1."""
    cfg = _cfgs()[1]
    one = bdpt.render_sample(cornell, cfg, 3)
    two = bdpt.render_sample(cornell, cfg, 3, batch=2)
    np.testing.assert_allclose(two.numpy(), 2 * one.numpy(), rtol=1e-5,
                               atol=1e-6 * float(one.max()))


def _mean_image(render, scene, cfg, samples, batch=1, step=1):
    fb = sum(render(scene, cfg, s * step, batch=batch) for s in range(samples))
    return fb.numpy() / (samples * batch)


def test_bdpt_matches_pt(cornell):
    """tests/test_bdpt.py::test_bdpt_matches_pt at its sizes and bounds
    (bdpt's batch copies repeat, so its progressions are separate)."""
    cfg = _cfgs(width=48, height=32, max_verts=5)[1]
    sc = convert.scene_from_numpy(jtesting.cornell_scene(sphere='diffuse'),
                                  device='cpu')
    a = _mean_image(bdpt.render_sample, sc, cfg, 3)
    b = _mean_image(pt_mod.render_sample, sc, cfg, 3, batch=16, step=16)
    assert np.isfinite(a).all() and a[..., 1].mean() > 0.0
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.12, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.5, corr


def test_bdpt_specular_scene():
    """Dielectric sphere: finite and within range of pt (tests/test_bdpt.py
    ::test_bdpt_specular_scene)."""
    sc = _pair('dielectric', 32, 24)[1]
    cfg = _cfgs(width=32, height=24, max_verts=5)[1]
    a = _mean_image(bdpt.render_sample, sc, cfg, 2)
    b = _mean_image(pt_mod.render_sample, sc, cfg, 2, batch=16, step=16)
    assert np.isfinite(a).all()
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.25, ratio


def _absorb():
    sc = jtesting.cornell_scene(sphere='absorb')
    # keep sigma moderate so transmitted paths survive (tests/test_bdpt.py)
    return sc.replace(materials=sc.materials.replace(
        med_mut_mul=sc.materials.med_mut_mul * 0.25))


def test_absorbing_media_matches_jax():
    """cfg.media on an absorbing interior: the same image as the JAX
    package, with its warning, word for word."""
    js, ts = _pair(js=_absorb())
    cfg_j, cfg_t = _cfgs(max_verts=5, media=True)
    with pytest.warns(UserWarning) as caught:
        got = bdpt.render_sample(ts, cfg_t, 2).numpy()
    assert str(caught[0].message) == (
        'bdpt applies interior-medium transmittance (absorption) on '
        'subpath edges and connections, but samples no in-scattering '
        'vertices: scattering (sigma_s > 0) media diverge from pt/ptdl; '
        'absorbing interiors agree')
    with pytest.warns(UserWarning):
        want = np.asarray(jax.jit(lambda s: jbdpt.render_sample(
            js, cfg_j, s))(jnp.uint32(2)))
    _images_agree(got, want)


def test_bdpt_absorbing_media_matches_ptdl():
    """tests/test_bdpt.py::test_bdpt_absorbing_media_matches_ptdl."""
    sc = _pair(js=_absorb())[1]
    cfg = _cfgs(max_verts=5, media=True)[1]
    with pytest.warns(UserWarning):
        a = _mean_image(bdpt.render_sample, sc, cfg, 3)
    b = _mean_image(pt_mod.render_sample, sc, cfg, 3, batch=4, step=4)
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.1, ratio
