"""Camera, lights, shading and BSDF of the port against the JAX package.

The same inputs (numpy, from a seed; scenes converted from the JAX ones)
go through both.  Tolerance: rtol 1e-5 with an atol of 1e-6 for values
that cancel towards 0 (float32 on both sides; XLA fuses some multiply-
adds that torch rounds twice and approximates sin/cos/rsqrt differently,
a few ulp per op through chains of ~20 ops).

Glossy GGX lanes (roughness > 0) are ill-conditioned: 1 - cos^2 cancels
at the lobe's peak (ulp differences grow by up to ~2/roughness^2) and
1/|cos| blows up at grazing angles.  There >= 99% of the lanes hold
rtol 1e-3 and every lane rtol 2e-2; the JAX suite's own battle test
(tests/test_bsdf.py) bounds sample-vs-eval pdf agreement at 3%.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import testing as jtesting
from corona13_tpu.models import bsdf as jbsdf
from corona13_tpu.models import camera as jcamera
from corona13_tpu.models import lights as jlights
from corona13_tpu.models import shading as jshading
from corona13_tpu.ops import trace as jtrace
from corona13_tpu_torch import convert
from corona13_tpu_torch.models import bsdf as tbsdf
from corona13_tpu_torch.models import camera as tcamera
from corona13_tpu_torch.models import lights as tlights
from corona13_tpu_torch.models import shading as tshading
from corona13_tpu_torch.ops import trace as ttrace

RTOL, ATOL = 1e-5, 1e-6
N = 2048
MF = 4


def _close(j, t, rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _close_bsdf(j, t, rough):
    """rtol 1e-5 on specular lanes (roughness 0), the glossy bar of the
    module docstring on the GGX lanes."""
    j, t = np.asarray(j), t.numpy()
    glossy = rough > 0.0
    _close(j[~glossy], t[~glossy])
    if glossy.any():
        err = np.abs(t - j) / (np.abs(j) + 1e-3)  # atol 1e-6 at rtol 1e-3
        err = err.reshape(len(j), -1).max(axis=-1)[glossy]
        assert (err <= 1e-3).mean() >= 0.99
        assert err.max() <= 2e-2


def _u(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture(scope='module')
def scenes():
    js = jtesting.cornell_scene(sphere='metal')
    return js, convert.scene_from_numpy(js)


def test_camera_sample(scenes):
    js, ts = scenes
    pi, pj = _u(0, N) * 64, _u(1, N) * 36
    a1, a2, tm = _u(2, N), _u(3, N), _u(4, N)
    jo = jcamera.sample(js.camera, 64, 36, *map(jnp.asarray, (pi, pj, a1, a2,
                                                             tm)))
    to = tcamera.sample(ts.camera, 64, 36, *map(torch.as_tensor, (pi, pj, a1,
                                                                 a2, tm)))
    for j, t in zip(jo, to):
        _close(j, t)


def test_lights_sample_and_eval(scenes):
    js, ts = scenes
    x = (_u(5, N, 3) * 10 - 5).astype(np.float32)
    r = [_u(6 + i, N) for i in range(3)]
    jl = jlights.sample_nee(js.lights, js.geom, jnp.asarray(x),
                            *map(jnp.asarray, r))
    tl = tlights.sample_nee(ts.lights, ts.geom, torch.as_tensor(x),
                            *map(torch.as_tensor, r))
    for k in ('pos', 'gn', 'pdf_area', 'u', 'v'):
        _close(jl[k], tl[k])
    np.testing.assert_array_equal(tl['prim'].numpy(), np.asarray(jl['prim']))
    em = _u(9, N, MF) * 3
    rough = np.where(_u(10, N) < 0.5, 1.0, _u(11, N)).astype(np.float32)
    wi = np.random.default_rng(12).normal(size=(N, 3)).astype(np.float32)
    _close(jlights.eval_vertex(jnp.asarray(em), jnp.asarray(rough), jl['gn'],
                               jnp.asarray(wi)),
           tlights.eval_vertex(torch.as_tensor(em), torch.as_tensor(rough),
                               tl['gn'], torch.as_tensor(wi)), rtol=1e-4)
    prim = np.arange(-1, 14).astype(np.int32)
    _close(jlights.nee_pdf_area(js.lights, jnp.asarray(prim)),
           tlights.nee_pdf_area(ts.lights, torch.as_tensor(prim).long()))


def test_shading_prepare_on_cornell_hits(scenes):
    """Hits from the JAX traversal feed both shading ports, so the test
    isolates shading from traversal tie-breaks."""
    js, ts = scenes
    g = np.random.default_rng(13)
    org = np.zeros((N, 3), np.float32) + g.normal(size=(N, 3)).astype(np.float32) * 0.5
    d = g.normal(size=(N, 3)).astype(np.float32) * [0.4, 0.4, 1.0]
    d[:, 2] = np.abs(d[:, 2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    org = org + [0.0, 0.0, 12.0]
    org = org.astype(np.float32)
    # half the rays start inside the box and point back at the camera side
    d[::2] *= -1
    hit = jtrace.intersect(js.geom, jnp.asarray(org), jnp.asarray(d))
    assert (np.asarray(hit.prim) >= js.geom.n_tris).any()   # sphere hits
    assert (np.asarray(hit.prim) < 0).any()                 # misses
    x = np.asarray(jnp.asarray(org) + jnp.where(hit.valid, hit.t, 0.0)[:, None]
                   * jnp.asarray(d))
    lam = (360.0 + 470.0 * _u(14, N, MF)).astype(np.float32)
    jsp = jshading.prepare(js, hit, jnp.asarray(x), jnp.asarray(d),
                           jnp.asarray(lam))
    thit = ttrace.Hit(t=torch.as_tensor(np.asarray(hit.t)),
                      prim=torch.as_tensor(np.asarray(hit.prim)).long(),
                      u=torch.as_tensor(np.asarray(hit.u)),
                      v=torch.as_tensor(np.asarray(hit.v)),
                      slot=torch.as_tensor(np.asarray(hit.slot)).long())
    tsp = tshading.prepare(ts, thit, torch.as_tensor(x), torch.as_tensor(d),
                           torch.as_tensor(lam))
    for f in dataclasses.fields(tsp):
        j, t = getattr(jsp, f.name), getattr(tsp, f.name)
        if t.dtype in (torch.bool, torch.int64):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), f.name)
        else:
            _close(j, t)


def _shading_points(kind, seed):
    """Random shading points of one kind: random normals (shading normal
    tilted off the geometric one), inside flags, roughness from specular
    to diffuse, spectral IORs and conductor constants."""
    g = np.random.default_rng(seed)
    gn = g.normal(size=(N, 3)).astype(np.float32)
    gn /= np.linalg.norm(gn, axis=-1, keepdims=True)
    n = gn + 0.2 * g.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rough = g.choice(np.array([0.0, 0.05, 0.3, 1.0], np.float32), N)
    inside = g.uniform(size=N) < 0.3
    eta = (1.3 + 0.4 * g.uniform(size=(N, MF))).astype(np.float32)
    eta_ratio = np.where(inside[:, None], eta, 1.0 / eta).astype(np.float32)
    arrays = dict(
        kind=np.full(N, kind, np.int32),
        rd=g.uniform(0, 1, (N, MF)).astype(np.float32),
        rg=g.uniform(0.2, 1, (N, MF)).astype(np.float32),
        em=np.zeros((N, MF), np.float32),
        roughness=rough, eta_ratio=eta_ratio,
        fresnel_eta=g.uniform(0.1, 1.5, (N, MF)).astype(np.float32),
        fresnel_k=g.uniform(2, 5, (N, MF)).astype(np.float32),
        n=n.astype(np.float32), gn=gn, inside=inside,
        tangent=np.zeros((N, 3), np.float32))
    jsp = jbsdf.ShadingPoint(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tsp = tbsdf.ShadingPoint(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    tsp.kind = tsp.kind.long()
    # incoming directions on the side the normals face (or behind, inside)
    wi = g.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    side = np.sum(wi * gn, axis=-1) > 0
    wi = np.where((side != inside)[:, None], -wi, wi).astype(np.float32)
    return jsp, tsp, wi


@pytest.mark.parametrize('kind', [jbsdf.DIFFUSE, jbsdf.DIELECTRIC,
                                  jbsdf.METAL])
def test_bsdf_sample_and_eval(kind):
    jsp, tsp, wi = _shading_points(kind, 20 + kind)
    r1, r2, rm = _u(30, N), _u(31, N), _u(32, N)
    kinds = (jbsdf.DIFFUSE, jbsdf.DIELECTRIC, jbsdf.METAL)
    jo = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), *map(jnp.asarray, (r1, r2, rm)),
                           kinds=kinds)
    to = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi),
                           *map(torch.as_tensor, (r1, r2, rm)), kinds=kinds)
    rough = np.asarray(jsp.roughness)
    if kind == jbsdf.DIFFUSE:
        rough = np.zeros_like(rough)      # no GGX lobe on diffuse lanes
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    assert (np.asarray(jo[3]) != 0).mean() > 0.3
    for j, t in zip(jo[:3], to[:3]):
        _close_bsdf(j, t, rough)
    # connections toward random directions on both sides
    wo = np.random.default_rng(33).normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    jf = jbsdf.bsdf_eval_pdf(jsp, jnp.asarray(wi), jnp.asarray(wo), kinds=kinds)
    tf = tbsdf.bsdf_eval_pdf(tsp, torch.as_tensor(wi), torch.as_tensor(wo),
                             kinds=kinds)
    assert (np.asarray(jf[0]) > 0).mean() > 0.1
    for j, t in zip(jf, tf):
        _close_bsdf(j, t, rough)


def test_unported_kinds_raise():
    _, tsp, wi = _shading_points(jbsdf.DIFFUSE, 1)
    r = torch.as_tensor(_u(2, N))
    with pytest.raises(NotImplementedError):
        tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), r, r, r,
                          kinds=(tbsdf.DIFFUSE, tbsdf.HAIR))
    with pytest.raises(NotImplementedError):
        tbsdf.bsdf_eval_pdf(tsp, torch.as_tensor(wi), torch.as_tensor(wi),
                            kinds=(tbsdf.DIFFDIEL,))
