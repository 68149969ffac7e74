"""The port's traversal against the JAX package.

``traverse_tris_plain`` (what the CUDA kernel computes, in torch) against
the Pallas kernel in interpret mode on the arrays of tests/test_bvh.py:
prim and slot identical on >= 99.5% of rays (the JAX suite's own bar,
test_bvh.py:118), t within rtol 1e-5 and u/v within atol 1e-5 where prim
agrees (XLA fuses multiply-adds the plain version rounds twice).  Any-hit
must agree exactly with closest-hit blocking.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import testing as jtesting
from corona13_tpu.ops import trace as jtrace
from corona13_tpu.ops import trace_pallas
from corona13_tpu_torch import convert
from corona13_tpu_torch import testing as ttesting
from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_cuda


def _random_tris(n, seed=0):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-10, 10, (n, 3)).astype(np.float32)
    e = r.uniform(-3.0, 3.0, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    org = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


@pytest.fixture(scope='module')
def soup():
    geom = jtrace.make_device_geometry(tri_v=_random_tris(700, seed=11))
    return geom, convert.scene_from_numpy(geom.tri_bvh)


def _both(soup, org, d, t0, ig, ig2=None, any_hit=False):
    jb, tb = soup[0].tri_bvh, soup[1]
    j = trace_pallas.traverse_tris(
        jb.wbounds, jb.wlinks, jb.leaf_packed, jnp.asarray(org), jnp.asarray(d),
        jnp.asarray(t0), jnp.asarray(ig),
        None if ig2 is None else jnp.asarray(ig2), any_hit=any_hit,
        interpret=True)
    T = torch.as_tensor
    t = trace_cuda.traverse_tris_plain(
        tb.wbounds, tb.wlinks, tb.leaf_packed, T(org), T(d), T(t0), T(ig),
        None if ig2 is None else T(ig2), any_hit=any_hit)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_plain_closest_hit_matches_pallas(soup):
    n = 300
    org, d = _rays(n, 4)
    t0 = np.full(n, 3.0e38, np.float32)
    t0[::7] = 15.0                       # bounded segments
    t0[:11] = 0.0                        # dead lanes do no work
    ig = np.full(n, -1, np.int32)
    ig[100:160] = np.arange(60) * 5      # one excluded prim per ray
    (jt, jp, ju, jv, js), (tt, tp, tu, tv, ts) = _both(soup, org, d, t0, ig)
    assert (tp >= 0).mean() > 0.2
    assert (tp == jp).mean() >= 0.995
    assert (ts == js).mean() >= 0.995
    agree = (tp == jp) & (tp >= 0)
    np.testing.assert_allclose(tt[agree], jt[agree], rtol=1e-5)
    np.testing.assert_allclose(tu[agree], ju[agree], atol=1e-5)
    np.testing.assert_allclose(tv[agree], jv[agree], atol=1e-5)
    # dead lanes: t = t_init, no hit, no slot, u = v = 0
    assert (tp[:11] == -1).all() and (ts[:11] == -1).all()
    assert (tt[:11] == 0.0).all() and (tu[:11] == 0.0).all()
    # slot addresses the winning row: the packed row's prim is the hit prim
    lp = soup[1].leaf_packed.reshape(-1, 16).numpy()
    hit = tp >= 0
    np.testing.assert_array_equal(lp[ts[hit], 9].astype(np.int32), tp[hit])


def test_plain_any_hit_matches_closest(soup):
    """blocked == valid & (t < t_max), as at test_bvh.py:126-132, with both
    exclusions active and dead lanes."""
    n = 300
    org, d = _rays(n, 5)
    ig = np.full(n, -1, np.int32)
    t_far = np.full(n, 3.0e38, np.float32)
    _, (ct, cp, _, _, _) = _both(soup, org, d, t_far, ig)
    # exclude each ray's first blocker through either slot on some lanes
    ig1 = np.where(np.arange(n) % 3 == 1, cp, -1).astype(np.int32)
    ig2 = np.where(np.arange(n) % 3 == 2, cp, -1).astype(np.int32)
    _, (xt, xp, _, _, _) = _both(soup, org, d, t_far,
                                 np.maximum(ig1, ig2).astype(np.int32))
    t_max = np.full(n, 20.0, np.float32)
    t_max[:9] = 0.0
    (_, jb, _, _, _), (_, tb, _, _, _) = _both(soup, org, d, t_max, ig1, ig2,
                                               any_hit=True)
    expect = (xp >= 0) & (xt < t_max)
    np.testing.assert_array_equal(tb >= 0, expect)
    np.testing.assert_array_equal(tb >= 0, jb >= 0)
    assert expect.any() and not (tb[:9] >= 0).any()


def test_device_bvh_matches_jax():
    """The port's upload of the same host BVH gives the JAX package's
    arrays bit for bit (the kernel walks exactly the reference tree)."""
    tri_v = _random_tris(300, seed=2)
    jg = jtrace.make_device_geometry(tri_v=tri_v)
    tg = ttrace.make_device_geometry(tri_v=tri_v)
    for name in ('nodes', 'leaf_prims', 'leaf_data', 'leaf_shade', 'wbounds',
                 'wlinks', 'leaf_packed'):
        np.testing.assert_array_equal(
            getattr(tg.tri_bvh, name).numpy(),
            np.asarray(getattr(jg.tri_bvh, name)), name)
    assert tg.tri_bvh.wlinks.dtype == torch.int32


@pytest.mark.parametrize('kind,n', [('tri', 1), ('tri', 9), ('tri', 2500),
                                    ('sphere', 40), ('line', 30)])
def test_host_bvh_build_matches_jax(kind, n):
    """The port's numpy BVH builder and collapse8 give the JAX package's
    arrays (its native C++ builder where that compiles) bit for bit."""
    from corona13_tpu.ops import bvh as jbvh
    from corona13_tpu_torch.ops import bvh as tbvh
    g = np.random.default_rng(n)
    if kind == 'tri':
        args = (_random_tris(n, seed=n),)
    elif kind == 'sphere':
        args = (g.uniform(-9, 9, (n, 3)).astype(np.float32),
                g.uniform(0.1, 2, n).astype(np.float32))
    else:
        args = (g.uniform(-9, 9, (n, 2, 3)).astype(np.float32),
                g.uniform(0.05, 0.5, (n, 2)).astype(np.float32))
    jb = jbvh.build_bvh(*getattr(jbvh, f'{kind}_bounds')(*args))
    tb = tbvh.build_bvh(*getattr(tbvh, f'{kind}_bounds')(*args))
    for name in ('node_min', 'node_max', 'node_skip', 'node_first',
                 'node_right', 'leaf_prims'):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    assert tb.n_prims == jb.n_prims
    for a, b in zip(tbvh.collapse8(tb), jbvh.collapse8(jb)):
        np.testing.assert_array_equal(a, b)


def test_deep_tree_is_refused(monkeypatch):
    """A tree whose worst-case stack (wdepth*7 + 8) exceeds the kernel's
    gets no wide layout, and the query raises instead of overflowing."""
    tri_v = _random_tris(300, seed=3)
    assert ttrace.make_device_geometry(tri_v=tri_v).tri_bvh.wbounds is not None
    monkeypatch.setattr(trace_cuda, 'MAX_STACK', 8)
    g = ttrace.make_device_geometry(tri_v=tri_v)
    assert g.tri_bvh.wbounds is None
    with pytest.raises(NotImplementedError):
        ttrace.intersect(g, torch.zeros(4, 3), torch.ones(4, 3))


@pytest.fixture(scope='module')
def cornell():
    js = jtesting.cornell_scene(sphere='diffuse')
    return js, convert.scene_from_numpy(js)


def _scene_rays(n, seed):
    g = np.random.default_rng(seed)
    org = (g.uniform(-4.5, 4.5, (n, 3)) + [0, 0, 15]).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


def test_intersect_and_occluded_on_cornell(cornell):
    """Port intersect/occluded (kernel path + dense sphere test) against
    the JAX package's CPU path on the cornell geometry.  Hits agree except
    where a ray crosses a quad's diagonal: JAX's CPU traversal keeps the
    later of two equal hits (tt <= t), the kernel the first (tt < t)."""
    js, ts = cornell
    n = 2000
    org, d = _scene_rays(n, 8)
    ig = np.where(np.arange(n) % 4 == 0, 12, -1).astype(np.int32)  # sphere
    jh = jtrace.intersect(js.geom, jnp.asarray(org), jnp.asarray(d),
                          ignore_prim=jnp.asarray(ig))
    th = ttrace.intersect(ts.geom, torch.as_tensor(org), torch.as_tensor(d),
                          ignore_prim=torch.as_tensor(ig).long())
    jp, tp = np.asarray(jh.prim), th.prim.numpy()
    assert (tp == js.geom.n_tris).any()           # sphere hits
    assert ((tp == jp) | ((tp >= 0) & (jp >= 0) & (tp // 2 == jp // 2))).all()
    assert (tp == jp).mean() >= 0.995
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    t_max = np.where(np.arange(n) % 2 == 0, np.asarray(jh.t) * 0.5,
                     np.asarray(jh.t) * 1.5).astype(np.float32)
    t_max[:13] = 0.0
    for ig2 in (None, jp.astype(np.int32)):
        jb = jtrace.occluded(js.geom, jnp.asarray(org), jnp.asarray(d),
                             jnp.asarray(t_max), ignore_prim=jnp.asarray(ig),
                             ignore_prim2=None if ig2 is None else
                             jnp.asarray(ig2))
        tb = ttrace.occluded(ts.geom, torch.as_tensor(org), torch.as_tensor(d),
                             torch.as_tensor(t_max),
                             ignore_prim=torch.as_tensor(ig).long(),
                             ignore_prim2=None if ig2 is None else
                             torch.as_tensor(ig2).long())
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert not tb[:13].any()


def test_port_cornell_scene_matches_jax(cornell):
    """testing.cornell_scene of the port: BVH arrays identical to the
    converted JAX scene, fitted reflectance spectra within 1e-4."""
    js, ts = cornell
    ps = ttesting.cornell_scene(sphere='diffuse')
    for name in ('nodes', 'leaf_prims', 'leaf_data', 'leaf_shade', 'wbounds',
                 'wlinks', 'leaf_packed'):
        np.testing.assert_array_equal(   # (NaN-coded int columns: equal)
            getattr(ps.geom.tri_bvh, name).numpy(),
            getattr(ts.geom.tri_bvh, name).numpy(), name)
    lam = torch.linspace(360, 830, 95)
    from corona13_tpu_torch.spectral import rgb2spec
    m, n = ps.materials, ts.materials
    for c, mul in (('d_coeff', 'd_mul'), ('g_coeff', 'g_mul'),
                   ('e_coeff', 'e_mul')):
        a = getattr(m, mul)[:, None] * rgb2spec.eval_coeff(
            getattr(m, c)[:, None, :], lam)
        b = getattr(n, mul)[:, None] * rgb2spec.eval_coeff(
            getattr(n, c)[:, None, :], lam)
        scale = torch.clamp(getattr(n, mul), min=1.0)[:, None]
        assert ((a - b).abs() / scale).max() < 1e-4
    torch.testing.assert_close(ps.lights.prim, ts.lights.prim, rtol=0, atol=0)
    torch.testing.assert_close(ps.lights.cdf, ts.lights.cdf, rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(ps.camera.focus, ts.camera.focus)
    assert ps.kinds_used == ts.kinds_used


def test_candidate_intersectors_match_jax():
    """Dense Moeller-Trumbore and sphere tests on [N, K] candidates, rtol
    1e-5 / atol 1e-5 (the two packages sum the cross products in different
    orders)."""
    tri = _random_tris(16, seed=21)
    rows = np.concatenate([tri[:, 0], tri[:, 1] - tri[:, 0],
                           tri[:, 2] - tri[:, 0]], axis=1)[None]
    org, d = _rays(400, 22)
    jt, ju, jv, jok = jtrace.ray_tri_intersect_packed(
        jnp.asarray(rows), jnp.asarray(org), jnp.asarray(d))
    tt, tu, tv, tok = ttrace.ray_tri_intersect_packed(
        torch.as_tensor(rows), torch.as_tensor(org), torch.as_tensor(d))
    ok = np.asarray(jok)
    assert ok.any() and (tok.numpy() == ok).mean() > 0.999
    both = ok & tok.numpy()
    for j, t in ((jt, tt), (ju, tu), (jv, tv)):
        np.testing.assert_allclose(t.numpy()[both], np.asarray(j)[both],
                                   rtol=1e-5, atol=1e-5)
    c = np.random.default_rng(23).uniform(-8, 8, (1, 5, 3)).astype(np.float32)
    r = np.full((1, 5), 3.0, np.float32)
    js, jsok = jtrace.ray_sphere_intersect(jnp.asarray(c), jnp.asarray(r),
                                           jnp.asarray(org), jnp.asarray(d))
    ts, tsok = ttrace.ray_sphere_intersect(torch.as_tensor(c),
                                           torch.as_tensor(r),
                                           torch.as_tensor(org),
                                           torch.as_tensor(d))
    np.testing.assert_array_equal(tsok.numpy(), np.asarray(jsok))
    np.testing.assert_allclose(ts.numpy()[tsok.numpy()],
                               np.asarray(js)[tsok.numpy()], rtol=1e-5)
