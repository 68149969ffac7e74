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

HAIR lanes have a bar of their own, between the two (_close_hair): float32
does not carry 1e-5 through erfinv and the gaussian cone on every lane, on
either side, which test_hair_rounding_noise measures against float64.
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
    return js, convert.scene_from_numpy(js, device='cpu')


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
                                  jbsdf.METAL, jbsdf.DIFFDIEL])
def test_bsdf_sample_and_eval(kind):
    jsp, tsp, wi = _shading_points(kind, 20 + kind)
    r1, r2, rm = _u(30, N), _u(31, N), _u(32, N)
    kinds = (jbsdf.DIFFUSE, jbsdf.DIELECTRIC, jbsdf.METAL, jbsdf.DIFFDIEL)
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


def _hair_points(seed, kinds=(jbsdf.HAIR,)):
    """Shading points of the given kinds (lane i gets kinds[i % len]) with
    random unit fibre tangents."""
    jsp, tsp, wi = _shading_points(kinds[0], seed)
    g = np.random.default_rng(seed + 100)
    tan = g.normal(size=(N, 3)).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    kind = np.asarray(kinds, np.int32)[np.arange(N) % len(kinds)]
    jsp = jsp.replace(tangent=jnp.asarray(tan), kind=jnp.asarray(kind))
    tsp = dataclasses.replace(tsp, tangent=torch.as_tensor(tan),
                              kind=torch.as_tensor(kind).long())
    return jsp, tsp, wi


def _hair_err(j, t):
    """|t - j| / (|j| + 1e-3) per lane, the largest over a lane's values."""
    j, t = np.asarray(j, np.float64), np.asarray(t, np.float64)
    return (np.abs(t - j) / (np.abs(j) + 1e-3)).reshape(len(j), -1).max(axis=-1)


def _close_hair(j, t):
    """The HAIR bar: |port - jax| / (|jax| + 1e-3) per lane is at most
    1e-5 on >= 97.5% of the lanes, 1e-4 on >= 99.8% and 2e-3 on every lane.
    Not 1e-5 on every lane: float32 does not carry it, on either side.
    Held against the port evaluated in float64, hair_sample in the JAX
    package's own float32 is above 1e-5 on 2.3% of the lanes for wo and
    1.7% for pdf_proj, the port's float32 on 2.4% and 1.4%
    (test_hair_rounding_noise measures and holds this), at every
    roughness from 0.02 to 1.0: the noise enters through erfinv, through
    co - ci over beta, through sqrt(1 - co^2) and through 1/|cos|, not
    through 1/beta^2 alone.  A wrong lobe or a wrong normalisation moves a
    lane by 1e-1 and more, so the bound on every lane catches it; the
    worst lane measured is 1.1e-3 (co = -0.99993, where 1 - co^2
    cancels)."""
    err = _hair_err(j, t.numpy())
    assert (err <= 1e-5).mean() >= 0.975
    assert (err <= 1e-4).mean() >= 0.998
    assert err.max() <= 2e-3


def _double(sp):
    """A torch ShadingPoint with its float fields in float64."""
    return dataclasses.replace(sp, **{
        f.name: getattr(sp, f.name).double()
        for f in dataclasses.fields(sp)
        if isinstance(getattr(sp, f.name), torch.Tensor)
        and getattr(sp, f.name).is_floating_point()})


def test_hair_rounding_noise():
    """Why the HAIR bar is not 1e-5 on every lane: the port in float64 is
    the yardstick, and the JAX package's float32 hair_sample strays from it
    as far and as often as the port's float32 does.  Both stay inside the
    HAIR bar against the yardstick, so the two float32 versions compute one
    formula and differ by rounding; the shares are printed (pytest -s) per
    output and per roughness."""
    jsp, tsp, wi = _hair_points(60)
    r1, r2, rm = _u(61, N), _u(62, N), _u(63, N)
    J, T = jnp.asarray, torch.as_tensor
    D = lambda x: torch.as_tensor(x).double()
    jo = jbsdf.hair_sample(jsp, J(wi), J(r1), J(r2), J(rm))
    to = tbsdf.hair_sample(tsp, T(wi), T(r1), T(r2), T(rm))
    do = tbsdf.hair_sample(_double(tsp), D(wi), D(r1), D(r2), D(rm))
    beta = np.maximum(np.asarray(jsp.roughness), 0.02)
    for name, j, t, d in zip(('wo', 'pdf_proj', 'w'), jo, to, do):
        assert d.dtype == torch.float64
        e_j, e_t = _hair_err(d.numpy(), j), _hair_err(d.numpy(), t.numpy())
        e = _hair_err(j, t.numpy())
        print(f'hair_sample {name}: lanes above 1e-5: jax f32 against '
              f'port f64 {(e_j > 1e-5).mean():.4f} (max {e_j.max():.3g}), '
              f'port f32 against port f64 {(e_t > 1e-5).mean():.4f} (max '
              f'{e_t.max():.3g}), port f32 against jax f32 '
              f'{(e > 1e-5).mean():.4f} (max {e.max():.3g}); by beta: '
              + ', '.join(f'{b:g}: {(e[beta == b] > 1e-5).mean():.4f}'
                          for b in np.unique(beta)))
        for err in (e_j, e_t):
            assert (err <= 1e-5).mean() >= 0.975
            assert (err <= 1e-4).mean() >= 0.998
            assert err.max() <= 2e-3
        # the noise is no smaller on the JAX side than a third of the
        # port's: it is float32's, not the port's own
        assert (e_j > 1e-5).mean() >= (e_t > 1e-5).mean() / 3


def test_unported_kinds_raise():
    """No kind is left unported: HAIR, which used to raise, samples and
    evaluates as the JAX package's (hair_sample, hair_eval_pdf, hair_pdf_w
    and hair_S elementwise), through the dispatch as well."""
    jsp, tsp, wi = _hair_points(60)
    r1, r2, rm = _u(61, N), _u(62, N), _u(63, N)
    J, T = jnp.asarray, torch.as_tensor
    jo = jbsdf.hair_sample(jsp, J(wi), J(r1), J(r2), J(rm))
    to = tbsdf.hair_sample(tsp, T(wi), T(r1), T(r2), T(rm))
    for j, t in zip(jo, to):
        _close_hair(j, t)
    wo = np.random.default_rng(64).normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    for name in ('hair_S', 'hair_pdf_w'):
        _close_hair(getattr(jbsdf, name)(jsp, J(wi), J(wo)),
                    getattr(tbsdf, name)(tsp, T(wi), T(wo)))
    jf = jbsdf.hair_eval_pdf(jsp, J(wi), J(wo))
    tf = tbsdf.hair_eval_pdf(tsp, T(wi), T(wo))
    assert (np.asarray(jf[0]) > 0).all()
    for j, t in zip(jf, tf):
        _close_hair(j, t)
    kinds = (tbsdf.DIFFUSE, tbsdf.HAIR)
    jd = jbsdf.bsdf_sample(jsp, J(wi), J(r1), J(r2), J(rm), kinds=kinds)
    td = tbsdf.bsdf_sample(tsp, T(wi), T(r1), T(r2), T(rm), kinds=kinds)
    np.testing.assert_array_equal(td[3].numpy(), np.asarray(jd[3]))
    assert (td[3] == (tbsdf.MODE_GLOSSY | tbsdf.MODE_REFLECT)).all()
    for j, t in zip(jd[:3], td[:3]):
        _close_hair(j, t)


def test_bsdf_dispatch_mixed_kinds_with_hair():
    """One wavefront with DIFFUSE, METAL, HAIR and NULL lanes: the dispatch
    selects each lane's kind as the JAX package's does (mode bits equal,
    values at the bar of each lane's lobe)."""
    kinds = (jbsdf.DIFFUSE, jbsdf.METAL, jbsdf.HAIR, jbsdf.NULL)
    jsp, tsp, wi = _hair_points(70, kinds)
    r1, r2, rm = _u(71, N), _u(72, N), _u(73, N)
    J, T = jnp.asarray, torch.as_tensor
    jo = jbsdf.bsdf_sample(jsp, J(wi), J(r1), J(r2), J(rm), kinds=kinds)
    to = tbsdf.bsdf_sample(tsp, T(wi), T(r1), T(r2), T(rm), kinds=kinds)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    kind = np.asarray(jsp.kind)
    for k in kinds:
        assert (np.asarray(jo[3])[kind == k] != 0).mean() > 0.3
    # each lane at its kind's bar: DIFFUSE and NULL rtol 1e-5, METAL the
    # glossy bar of the module docstring, HAIR the HAIR bar
    rough = np.where(kind == jbsdf.METAL, 1.0, 0.0)
    hair = kind == jbsdf.HAIR

    def close(j, t):
        _close_bsdf(np.asarray(j)[~hair], t[~hair], rough[~hair])
        _close_hair(np.asarray(j)[hair], t[hair])
    for j, t in zip(jo[:3], to[:3]):
        close(j, t)
    wo = np.random.default_rng(74).normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    jf = jbsdf.bsdf_eval_pdf(jsp, J(wi), J(wo), kinds=kinds)
    tf = tbsdf.bsdf_eval_pdf(tsp, T(wi), T(wo), kinds=kinds)
    for j, t in zip(jf, tf):
        close(j, t)
    assert (tf[0][kind == jbsdf.HAIR] > 0).all()
    assert (tf[0][kind == jbsdf.NULL] == 0).all()


# --- the DIFFDIEL battle test of tests/test_bsdf.py:138-164 ----------------

_KINDS = (tbsdf.DIFFUSE, tbsdf.DIELECTRIC, tbsdf.METAL, tbsdf.DIFFDIEL)

def _battle_sp(kind, roughness, n=4096, eta=1.5):
    ones = torch.ones((n, MF))
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    return tbsdf.ShadingPoint(
        kind=torch.full((n,), kind), rd=ones * 0.8, rg=ones * 1.0,
        em=torch.zeros((n, MF)), roughness=torch.full((n,), roughness),
        eta_ratio=ones / eta, fresnel_eta=ones * 0.2, fresnel_k=ones * 3.0,
        n=nrm, gn=nrm, inside=torch.zeros(n, dtype=torch.bool))


def _battle_wi(n=4096, theta_deg=40.0):
    t = np.radians(theta_deg)
    return torch.tensor([np.sin(t), 0.0, -np.cos(t)],
                        dtype=torch.float32).expand(n, 3)


@pytest.mark.parametrize('roughness', [0.4, 0.0])
def test_diffdiel_consistency(roughness):
    """pdf(sample) == pdf(eval) and weight * pdf == f on the connectable
    lanes (95th percentile within 3%, the JAX suite's bar); at roughness 0
    the reflect lobe goes specular and the diffuse transmit lobe still
    passes."""
    sp = _battle_sp(tbsdf.DIFFDIEL, roughness)
    wi = _battle_wi()
    r1, r2, rm = (torch.as_tensor(_u(40 + i, 4096)) for i in range(3))
    wo, pdf_s, w, mode = tbsdf.bsdf_sample(sp, wi, r1, r2, rm, kinds=_KINDS)
    f, pdf_e = tbsdf.bsdf_eval_pdf(sp, wi, wo, kinds=_KINDS)
    live = (torch.any(w > 0, dim=-1)
            & ((mode & tbsdf.MODE_SPECULAR) == 0)).numpy()
    assert live.mean() > 0.5
    pdf_s, pdf_e, f, w = (x.numpy() for x in (pdf_s, pdf_e, f, w))
    rel = np.abs(pdf_s - pdf_e) / np.maximum(pdf_s, 1e-6)
    assert np.quantile(rel[live], 0.95) < 0.03
    rel2 = np.abs(w * pdf_s - f) / np.maximum(f, 1e-4)
    assert np.quantile(rel2[live], 0.95) < 0.03


def test_diffdiel_transmits_diffusely():
    """Transmission goes into the surface with a cosine lobe, reflection
    stays above, and the weight is bounded by rg."""
    sp = _battle_sp(tbsdf.DIFFDIEL, 0.2)
    r1, r2, rm = (torch.as_tensor(_u(50 + i, 4096)) for i in range(3))
    wo, _, w, mode = tbsdf.bsdf_sample(sp, _battle_wi(), r1, r2, rm,
                                       kinds=_KINDS)
    live = torch.any(w > 0, dim=-1)
    trans = (((mode & tbsdf.MODE_TRANSMIT) > 0) & live).numpy()
    refl = (((mode & tbsdf.MODE_REFLECT) > 0) & live).numpy()
    cos_out = wo[:, 2].numpy()
    assert trans.mean() > 0.4
    assert (cos_out[trans] < 0).all() and (cos_out[refl] > 0).all()
    assert float(w.max()) <= 1.0 + 1e-4
