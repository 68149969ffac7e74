"""The port's gradients: ``backward()`` through ``pt.render_sample`` against
``jax.grad`` of the JAX package at the same scene and sample index.

The target is JAX's AD value, not finite differences: both packages
implement the same detached-sampling estimator (sampled directions,
distances and pdfs are constants of the backward pass, and so are the
traversal's hits), whose roughness and IOR gradients are known to differ
from finite differences (tests/test_grad.py).  Tolerances, relative to
JAX's gradient:

* ``e_mul``, ``d_mul``, ``sky_mul``, ``exposure_time`` (the image is linear
  in them): 1e-3; measured 1e-7, 1e-7, 8e-8 and 0;
* ``roughness``, ``ior_nd``, ``med_mut_mul``, ``med_g``, ``focus``,
  ``cam_pos``: 5e-3; measured 1.5e-4, 1.2e-5, 1.5e-6, 2e-7, 8e-4 (a
  gradient of 4e-6 left over by cancellation) and 9e-7.

JAX compiles every gradient (5 to 30 s each on one core), so each case is
one render and one gradient a package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import testing as jtesting
from corona13_tpu.models import envmap as jenvmap
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch.samplers import pt as pt_mod

CFG = dict(width=24, height=16, max_verts=4, mf=2, use_nee=True)
SMALL = dict(width=16, height=12, max_verts=4, mf=2, use_nee=True)
MEDIA = dict(width=16, height=12, max_verts=8, mf=2, use_nee=True, media=True)
OFF = np.array([0.3, 0.2, 0.5], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(table, leaf):
    """theta -> the scene with ``<table>.<leaf>`` scaled by theta, for a
    JAX scene (flax ``.replace``) and for the port's (dataclasses)."""
    def japply(s, t):
        tab = getattr(s, table)
        return s.replace(**{table: tab.replace(**{leaf: getattr(tab, leaf) * t})})

    def tapply(s, t):
        tab = getattr(s, table)
        return dataclasses.replace(s, **{table: dataclasses.replace(
            tab, **{leaf: getattr(tab, leaf) * t})})
    return japply, tapply


def _sky_mul():
    return (lambda s, t: s.replace(sky_mul=s.sky_mul * t),
            lambda s, t: dataclasses.replace(s, sky_mul=s.sky_mul * t))


def _cam_pos():
    def japply(s, t):
        return s.replace(camera=s.camera.replace(
            pos=s.camera.pos + (t - 1.0) * jnp.asarray(OFF)))

    def tapply(s, t):
        return dataclasses.replace(s, camera=dataclasses.replace(
            s.camera, pos=s.camera.pos + (t - 1.0) * torch.as_tensor(OFF)))
    return japply, tapply


def _sun_envmap(js):
    return js.with_envmap(jenvmap.make_gradient_sky(
        top=(0.05, 0.05, 0.08), bottom=(0.02, 0.02, 0.02),
        sun_dir=(0.3, 0.2, 0.9), sun_radiance=200.0, res=(16, 32)))


def _both(js, cfg_kw, japply, tapply):
    """(value, gradient) of mean(render_sample) at theta = 1 from jax.grad
    and from the port's backward() on the converted scene."""
    cfg_j = jpt.PTConfig(**cfg_kw)
    cfg_t = pt_mod.PTConfig(**cfg_kw)
    vj, gj = jax.value_and_grad(lambda t: jnp.mean(jpt.render_sample(
        japply(js, t), cfg_j, jnp.uint32(0))))(jnp.float32(1.0))
    ts = convert.scene_from_numpy(js, device='cpu')
    theta = torch.tensor(1.0, requires_grad=True)
    v = pt_mod.render_sample(tapply(ts, theta), cfg_t, 0).mean()
    v.backward()
    return float(vj), float(gj), float(v.detach()), float(theta.grad)


LINEAR = {
    'e_mul': (lambda: jtesting.cornell_scene(), CFG,
              lambda: _scaled('materials', 'e_mul')),
    'd_mul': (lambda: jtesting.cornell_scene(), CFG,
              lambda: _scaled('materials', 'd_mul')),
    'sky_mul': (lambda: jtesting.furnace_scene(albedo=0.5, emission=1.0), CFG,
                _sky_mul),
    'exposure_time': (lambda: jtesting.cornell_scene(), CFG,
                      lambda: _scaled('camera', 'exposure_time')),
    # the same under envmap NEE and under a capped wavefront
    'd_mul/envmap': (lambda: _sun_envmap(jtesting.cornell_scene()), CFG,
                     lambda: _scaled('materials', 'd_mul')),
    'e_mul/compact': (lambda: jtesting.cornell_scene(),
                      dict(CFG, compact=(1.0, 0.8, 0.6)),
                      lambda: _scaled('materials', 'e_mul')),
}


@pytest.mark.parametrize('name', list(LINEAR))
def test_grad_linear_matches_jax(name):
    scene, cfg_kw, applies = LINEAR[name]
    vj, gj, vt, gt = _both(scene(), cfg_kw, *applies())
    assert np.isfinite(gt) and abs(gj) > 0
    assert abs(vt - vj) <= 1e-5 * abs(vj), (vt, vj)
    assert abs(gt - gj) <= 1e-3 * abs(gj), (gt, gj)
    if name in ('e_mul', 'exposure_time', 'sky_mul'):
        # the image is proportional to the parameter: gradient == value
        assert abs(gt - vt) <= 5e-3 * abs(vt), (gt, vt)


NONLINEAR = {
    'roughness': (lambda: jtesting.cornell_scene(sphere='metal'), SMALL,
                  lambda: _scaled('materials', 'roughness')),
    'ior_nd': (lambda: jtesting.cornell_scene(sphere='dielectric'), SMALL,
               lambda: _scaled('materials', 'ior_nd')),
    'med_mut_mul': (lambda: jtesting.cornell_scene(sphere='subsurf'), MEDIA,
                    lambda: _scaled('materials', 'med_mut_mul')),
    'med_g': (lambda: jtesting.cornell_scene(sphere='subsurf'), MEDIA,
              lambda: _scaled('materials', 'med_g')),
    'focus': (lambda: jtesting.cornell_scene(), SMALL,
              lambda: _scaled('camera', 'focus')),
    'cam_pos': (lambda: jtesting.cornell_scene(), SMALL, _cam_pos),
}


@pytest.mark.parametrize('name', list(NONLINEAR))
def test_grad_nonlinear_matches_jax(name):
    """Finite, non-zero (the IOR gradient above all: the analytic
    F / choice-probability cancellation once zeroed it) and equal to
    JAX's AD value to 5e-3."""
    scene, cfg_kw, applies = NONLINEAR[name]
    vj, gj, vt, gt = _both(scene(), cfg_kw, *applies())
    assert np.isfinite(gt), (name, gt)
    assert gt != 0.0 and gj != 0.0
    assert abs(vt - vj) <= 1e-4 * abs(vj), (vt, vj)
    assert abs(gt - gj) <= 5e-3 * abs(gj), (name, gt, gj)


def test_grad_matches_central_differences():
    """e_mul and d_mul against central differences of the port's own
    render under common random numbers (2e-3, as tests/test_grad.py
    holds the JAX package), no JAX involved."""
    from corona13_tpu_torch import testing
    sc = testing.cornell_scene(device='cpu')
    cfg = pt_mod.PTConfig(**CFG)
    for leaf in ('e_mul', 'd_mul'):
        _, tapply = _scaled('materials', leaf)
        f = lambda t: pt_mod.render_sample(tapply(sc, t), cfg, 0).mean()
        theta = torch.tensor(1.0, requires_grad=True)
        f(theta).backward()
        g = float(theta.grad)
        eps = 1e-3
        with torch.no_grad():
            fd = (float(f(torch.tensor(1.0 + eps)))
                  - float(f(torch.tensor(1.0 - eps)))) / (2 * eps)
        assert np.isfinite(g) and abs(g) > 0
        assert abs(g - fd) <= 2e-3 * max(abs(fd), 1e-6) + 1e-7, (leaf, g, fd)


def test_grad_leaves_and_no_grad_render():
    """Gradients reach the scene's own leaves (every material row that the
    image depends on, none NaN) and ``render.render`` records no graph."""
    from corona13_tpu_torch import testing
    sc = testing.cornell_scene(sphere='rough_dielectric', device='cpu')
    leaves = {k: getattr(sc.materials, k).clone().requires_grad_()
              for k in ('d_mul', 'e_mul', 'g_mul', 'roughness', 'ior_nd',
                        'ior_abbe')}
    sc_g = dataclasses.replace(sc, materials=dataclasses.replace(
        sc.materials, **leaves))
    cfg = pt_mod.PTConfig(**SMALL)
    accum, lam, _, _ = pt_mod.sample_paths(sc_g, cfg, 0, torch.arange(16 * 12))
    assert accum.requires_grad and not lam.requires_grad
    accum.sum().backward()
    for k, v in leaves.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
    assert (leaves['d_mul'].grad[:3] > 0).all()      # the three wall albedos
    assert leaves['e_mul'].grad[3] > 0               # the light
    assert leaves['ior_nd'].grad[4] != 0             # the sphere
    res = render_mod.render(sc_g, cfg, spp=1)
    assert np.isfinite(res.fb).all()
    with torch.no_grad():
        assert not pt_mod.render_sample(sc_g, cfg, 0).requires_grad
