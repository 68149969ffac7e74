"""The port's traversal against the JAX package.

``traverse_tris_plain`` (what the CUDA kernel computes, in torch) against
the Pallas kernel in interpret mode on the arrays of tests/test_bvh.py:
prim and slot identical on >= 99.5% of rays (the JAX suite's own bar,
test_bvh.py:118), t within rtol 1e-5 and u/v within atol 1e-5 where prim
agrees (XLA fuses multiply-adds the plain version rounds twice).  Any-hit
must agree exactly with closest-hit blocking.
"""

import inspect

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
    return geom, convert.scene_from_numpy(geom.tri_bvh, device='cpu')


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
    tg = ttrace.make_device_geometry(tri_v=tri_v, device='cpu')
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
    """A tree whose worst-case stack (wdepth*7 + 8) exceeds the kernel's is
    refused a wide layout, not a query: intersect and occluded walk it by
    its skip links and answer as the stack walk of the same triangles does
    (prim and blocked equal on >= 99.9% of rays, t within rtol 1e-6; the
    two walks visit leaves in different orders and pick the winner inside
    a leaf by different rules, so only exact-t ties may differ)."""
    tri_v = _random_tris(300, seed=3)
    wide = ttrace.make_device_geometry(tri_v=tri_v, device='cpu')
    assert wide.tri_bvh.wbounds is not None
    n = 1500
    org, d = (torch.as_tensor(x) for x in _rays(n, 31))
    ig = torch.full((n,), -1, dtype=torch.int64)
    first = ttrace.intersect(wide, org, d)
    ig[::3] = first.prim[::3]
    t_max = torch.full((n,), 3.0e38)
    t_max[::5] = 9.0
    t_max[:20] = 0.0
    hw = ttrace.intersect(wide, org, d, ignore_prim=ig, t_max=t_max)
    bw = ttrace.occluded(wide, org, d, t_max, ignore_prim=ig, ignore_prim2=ig)
    monkeypatch.setattr(trace_cuda, 'MAX_STACK', 8)
    g = ttrace.make_device_geometry(tri_v=tri_v, device='cpu')
    assert g.tri_bvh.wbounds is None and g.tri_bvh.knodes is None
    assert g.tri_bvh.kleaves is not None
    hd = ttrace.intersect(g, org, d, ignore_prim=ig, t_max=t_max)
    assert (hd.prim >= 0).float().mean() > 0.2
    assert (hd.prim == hw.prim).float().mean() >= 0.999
    assert (hd.slot == hw.slot).float().mean() >= 0.999
    same = hd.prim == hw.prim
    torch.testing.assert_close(hd.t[same], hw.t[same], rtol=1e-6, atol=0)
    torch.testing.assert_close(hd.u[same], hw.u[same], rtol=0, atol=1e-6)
    assert (hd.prim[:20] == -1).all() and (hd.t[:20] == 0).all()
    bd = ttrace.occluded(g, org, d, t_max, ignore_prim=ig, ignore_prim2=ig)
    assert bd.any() and (bd == bw).float().mean() >= 0.999


def test_static_wide_triangles_take_a_running_hit(monkeypatch):
    """closest_hit / any_hit serve the static triangles of a wide tree too
    (the TPU kernel's specialisations): from a carried running hit they
    answer as the skip-link walk of the same triangles does from the same
    hit (prim, slot and blocked equal on >= 99.9% of rays, t within rtol
    1e-6 where prim agrees), lanes the carried hit wins keep all five of
    its values, a blocked lane stays blocked, and ``carry`` itself is not
    modified on the CPU."""
    tri_v = _random_tris(300, seed=5)
    wide = ttrace.make_device_geometry(tri_v=tri_v, device='cpu').tri_bvh
    with monkeypatch.context() as m:       # no wide layout: skip links
        m.setattr(trace_cuda, 'MAX_STACK', 8)
        deep = ttrace.make_device_geometry(tri_v=tri_v, device='cpu').tri_bvh
    assert trace_cuda._form_of(wide, 'tri') == 'wide'
    assert trace_cuda._form_of(deep, 'tri') == 'deep'
    assert trace_cuda._count_key('wide', 'tri', False) == 'closest'
    assert trace_cuda._count_key('wide', 'tri', True) == 'any'
    n = 1500
    org, d = (torch.as_tensor(x) for x in _rays(n, 32))
    g = torch.Generator().manual_seed(6)
    t0 = torch.full((n,), 3.0e38)
    t0[:20] = 0.0
    t_run = torch.where(torch.rand(n, generator=g) < 0.5,
                        torch.rand(n, generator=g) * 12.0, t0)
    carry = (t_run, torch.full((n,), 7), torch.full((n,), 0.25),
             torch.full((n,), 0.5), torch.full((n,), 3))
    kept = tuple(x.clone() for x in carry)
    hw = trace_cuda.closest_hit(wide, 'tri', org, d, t0, carry=carry)
    hd = trace_cuda.closest_hit(deep, 'tri', org, d, t0, carry=carry)
    assert all(torch.equal(a, b) for a, b in zip(carry, kept))
    improved = hw[0] != t_run
    assert improved.float().mean() > 0.1 and (~improved).float().mean() > 0.3
    assert (hw[0][improved] < t_run[improved]).all()
    for x, y in zip(hw, kept):
        assert torch.equal(x[~improved], y[~improved])
    same = hw[1] == hd[1]
    assert same.float().mean() >= 0.999
    assert (hw[4] == hd[4]).float().mean() >= 0.999
    torch.testing.assert_close(hw[0][same], hd[0][same], rtol=1e-6, atol=0)
    blocked = torch.rand(n, generator=g) < 0.2
    t_seg = torch.full((n,), 9.0)
    bw = trace_cuda.any_hit(wide, 'tri', org, d, t_seg, carry=blocked)
    bd = trace_cuda.any_hit(deep, 'tri', org, d, t_seg, carry=blocked)
    fresh = trace_cuda.any_hit(wide, 'tri', org, d, t_seg)
    assert torch.equal(bw, blocked | fresh) and (bw & ~blocked).any()
    assert (bw == bd).float().mean() >= 0.999


@pytest.fixture(scope='module')
def cornell():
    js = jtesting.cornell_scene(sphere='diffuse')
    return js, convert.scene_from_numpy(js, device='cpu')


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
    ps = ttesting.cornell_scene(sphere='diffuse', device='cpu')
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


def _one_live_lane_per_tile(n_blocks, seed, t_live):
    """n_blocks*1024 rays with exactly one live lane per 128-ray tile
    (t_init = 0 elsewhere); t_live [n_blocks*8] is the live lanes' t_init."""
    n = n_blocks * trace_cuda.BLOCK
    org, d = _rays(n, seed)
    t0 = np.zeros(n, np.float32)
    live = np.arange(0, n, 128) + np.random.default_rng(seed).integers(
        0, 128, n // 128)
    t0[live] = t_live
    return org, d, t0, live


def test_plain_counters_match_pallas(soup):
    """want_counters: the port's per-block inner and leaf pops (the union
    walk of each 128-ray tile, ``trace_cuda.union_walk_plain``) against
    the Pallas kernel in interpret mode, one live lane per 128-ray tile.
    Equal on every block, closest-hit and any-hit: where a tile's one ray
    is blocked, both keep popping, since a tile stops only once all 128
    lanes are blocked (trace_pallas.py:159,188-193).  (t, prim, u, v,
    slot) as in the tests above; tests/test_torch_union_walk.py holds the
    walk on full tiles too."""
    nb = 6
    t_live = np.where(np.arange(nb * 8) < 24, 3.0e38, 1.5).astype(np.float32)
    org, d, t0, live = _one_live_lane_per_tile(nb, 9, t_live)
    ig = np.full(len(t0), -1, np.int32)
    for any_hit in (False, True):
        jb, tb = soup[0].tri_bvh, soup[1]
        j = trace_pallas.traverse_tris(
            jb.wbounds, jb.wlinks, jb.leaf_packed, jnp.asarray(org),
            jnp.asarray(d), jnp.asarray(t0), jnp.asarray(ig), any_hit=any_hit,
            interpret=True, want_counters=True)
        T = torch.as_tensor
        t = trace_cuda.traverse_tris(tb, T(org), T(d), T(t0), T(ig),
                                     any_hit=any_hit, want_counters=True)
        j = [np.asarray(x) for x in j]
        t = [x.numpy() for x in t]
        assert len(t) == 7 and t[5].shape == t[6].shape == (nb,)
        assert t[5].dtype == t[6].dtype == np.int32
        np.testing.assert_array_equal(t[1] >= 0, j[1] >= 0)
        np.testing.assert_array_equal(t[5], j[5])
        np.testing.assert_array_equal(t[6], j[6])
        if not any_hit:
            np.testing.assert_array_equal(t[1], j[1])
            np.testing.assert_array_equal(t[4], j[4])
            np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
            assert (t[6] > 0).all() and (t[5] > t[6]).all()
        else:
            blocked = (t[1][live] >= 0).reshape(nb, 8).any(axis=1)
            assert blocked.any() and not blocked.all()
    # an N that is no multiple of 1024: padded like the JAX package
    n = 1500
    o, dd = _rays(n, 3)
    out = trace_cuda.traverse_tris_plain(
        tb.wbounds, tb.wlinks, tb.leaf_packed, T(o), T(dd),
        T(np.full(n, 3.0e38, np.float32)), T(np.full(n, -1, np.int32)),
        want_counters=True)
    assert out[5].shape == (2,) and out[6].shape == (2,)
    assert (out[5] >= 0).all() and int(out[5][1]) > 0


def _layout_bvh(which):
    if which == 'soup':
        return ttrace.make_device_geometry(tri_v=_random_tris(700, seed=11),
                                           device='cpu').tri_bvh
    make = {'cornell': ttesting.cornell_scene, 'plane': ttesting.plane_scene}
    return make[which](device='cpu').geom.tri_bvh


@pytest.mark.parametrize('which', ['soup', 'cornell', 'plane'])
def test_kernel_layout_round_trips(which):
    """The CUDA kernel's records (knodes: the link in the pad word;
    kleaves: 3 float4 a row, prim id as int bits) unpack to wbounds,
    wlinks and leaf_packed bit for bit, and are what DeviceBVH carries."""
    b = _layout_bvh(which)
    wb, wl, lp = (x.numpy() for x in (b.wbounds, b.wlinks, b.leaf_packed))
    kn, kl = trace_cuda.pack_kernel_layout(wb, wl, lp)
    assert kn.shape == wb.shape and kn.dtype == np.float32
    assert kl.shape == (lp.shape[0], 8, trace_cuda.LEAF_ROW)
    assert kn.flags.c_contiguous and kl.flags.c_contiguous
    np.testing.assert_array_equal(kn.view(np.int32),
                                  b.knodes.numpy().view(np.int32))
    np.testing.assert_array_equal(kl.view(np.int32),
                                  b.kleaves.numpy().view(np.int32))
    # what the kernel reads where: link bits, prim bits
    np.testing.assert_array_equal(kn[:, :, 7].view(np.int32).reshape(-1), wl)
    np.testing.assert_array_equal(kl[:, :, 3].view(np.int32),
                                  lp[:, :, 9].astype(np.int32))
    uwb, uwl, ulp = trace_cuda.unpack_kernel_layout(kn, kl)
    assert uwl.dtype == np.int32
    np.testing.assert_array_equal(uwb.view(np.int32), wb.view(np.int32))
    np.testing.assert_array_equal(uwl, wl)
    np.testing.assert_array_equal(ulp.view(np.int32), lp.view(np.int32))


@pytest.mark.parametrize('wdepth,depth', [(1, 15), (4, 36), (8, 64),
                                          (26, 190), (27, None), (40, None)])
def test_stack_depth_choice(wdepth, depth):
    """The kernel's stack holds wdepth*7 + 8 entries a thread, chosen at
    upload; above MAX_STACK = 192 the tree is refused."""
    assert trace_cuda.MAX_STACK == 192
    assert trace_cuda.stack_depth(wdepth) == depth


@pytest.mark.parametrize('which', ['soup', 'cornell', 'plane'])
def test_uploaded_stack_depth(which):
    """DeviceBVH.stack_depth is the choice for collapse8's depth, which
    wide_depth recovers from the arrays (as convert does for a JAX BVH)."""
    from corona13_tpu_torch.ops import bvh as tbvh
    b = _layout_bvh(which)
    wd = trace_cuda.wide_depth(b.wbounds.numpy(), b.wlinks.numpy())
    assert b.stack_depth == wd * 7 + 8 <= trace_cuda.MAX_STACK
    if which == 'soup':
        tri_v = _random_tris(700, seed=11)
        flat = tbvh.build_bvh(*tbvh.tri_bounds(tri_v))
        assert tbvh.collapse8(flat)[2] == wd
    assert wd == {'cornell': 1, 'plane': 4}.get(which, wd)


@pytest.mark.parametrize('form', ['int64', 'none', 'scalar_t', 'scalar_any'])
def test_wrapper_argument_forms(soup, form):
    """traverse_tris on CPU tensors through each argument form the wrapper
    takes (int64 ignore ids, None for no exclusion, one float for t_init)
    against the int32/tensor form: prim and slot exact, t bit-equal; and
    against the Pallas kernel in interpret mode with the bars of
    test_plain_closest_hit_matches_pallas (>= 99.5% of rays, rtol 1e-5)."""
    n = 256
    org, d = _rays(n, 14)
    T = torch.as_tensor
    any_hit = form == 'scalar_any'
    scalar = form.startswith('scalar')
    t0 = np.full(n, 18.0 if scalar else 3.0e38, np.float32)
    if not scalar:
        t0[::5] = 12.0
        t0[:7] = 0.0
    ig = np.full(n, -1, np.int32)
    if form == 'int64':
        ig[50:120] = np.arange(70) * 3
    ig2 = None if form == 'none' else ig[::-1].copy()
    (jt, jp, _, _, js), ref = _both(soup, org, d, t0, ig, ig2, any_hit=any_hit)
    tb = soup[1]
    if form == 'none':
        got = trace_cuda.traverse_tris(tb, T(org), T(d), T(t0))
    elif form == 'int64':
        got = trace_cuda.traverse_tris(tb, T(org), T(d), T(t0), T(ig).long(),
                                       T(ig2).long())
    else:
        got = trace_cuda.traverse_tris(tb, T(org), T(d), 18.0, T(ig),
                                       T(ig2), any_hit=any_hit)
    got = [x.numpy() for x in got]
    assert got[1].dtype == got[4].dtype == np.int64
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                      else a, b.view(np.int32)
                                      if b.dtype == np.float32 else b)
    if any_hit:
        np.testing.assert_array_equal(got[1] >= 0, jp >= 0)
        blocked = trace_cuda.occluded_tris(tb, T(org), T(d), 18.0, T(ig),
                                           T(ig2))
        assert blocked.dtype == torch.bool
        np.testing.assert_array_equal(blocked.numpy(), got[1] >= 0)
        assert blocked.any() and not blocked.all()
    else:
        assert (got[1] >= 0).mean() > 0.2
        assert (got[1] == jp).mean() >= 0.995
        assert (got[4] == js).mean() >= 0.995
        agree = (got[1] == jp) & (got[1] >= 0)
        np.testing.assert_allclose(got[0][agree], jt[agree], rtol=1e-5)


def test_wrapper_rejects_bad_inputs(soup):
    tb = soup[1]
    T = torch.as_tensor
    org, d = _rays(16, 2)
    t0 = np.full(16, 1e30, np.float32)
    ig = np.full(16, -1, np.int32)
    with pytest.raises(TypeError):       # ids must be int32 or int64
        trace_cuda.traverse_tris(tb, T(org), T(d), T(t0), T(ig).float())
    with pytest.raises(TypeError):       # both exclusions in one dtype
        trace_cuda.traverse_tris(tb, T(org), T(d), T(t0), T(ig), T(ig).long())
    with pytest.raises(ValueError):      # contiguous rays
        trace_cuda.traverse_tris(tb, T(org).t().contiguous().t(), T(d), T(t0))
    with pytest.raises(ValueError):
        trace_cuda.occluded_tris(tb, T(org), T(d), T(t0[:5]))


def test_entry_points_default_to_the_card():
    """The entry points that build a scene put it on the card unless the
    caller passes device='cpu'; the constructors under them take ``device`` as
    a required keyword, so nothing lands on the CPU unasked."""
    from corona13_tpu_torch import scene as tscene
    from corona13_tpu_torch.models import daylight, envmap, medium_hete
    from corona13_tpu_torch.parallel import dryrun, shard
    from corona13_tpu_torch.spectral import rgb2spec
    for fn in (tscene.load_scene, ttesting.assemble_scene,
               ttesting.cornell_scene, ttesting.plane_scene,
               ttesting.furnace_scene, convert.scene_from_numpy,
               envmap.build, daylight.build, shard.render_samples_sharded,
               shard.train_step, shard.train_step_theta,
               dryrun.dryrun_multichip, shard.rank_device):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn
    for fn in (tscene.material_table, ttrace.make_device_geometry,
               ttrace.DeviceBVH.from_host, medium_hete.from_volfile,
               rgb2spec.fit_coeff, rgb2spec.build_lut):
        par = inspect.signature(fn).parameters['device']
        assert par.default is inspect.Parameter.empty, fn
        assert par.kind is inspect.Parameter.KEYWORD_ONLY, fn
    with pytest.raises(TypeError):
        ttrace.make_device_geometry(tri_v=_random_tris(4))


def test_ray_tri_intersect_matches_jax():
    """The unpacked Moeller-Trumbore wrapper (tests/test_bvh.py's brute
    force) against the JAX package's: the hit mask, and t, u, v where it is
    set (a near-parallel miss divides by a tiny determinant, where XLA's
    and torch's roundings part)."""
    tri = _random_tris(300)
    r = np.random.default_rng(7)
    org = r.uniform(-12, 12, (64, 3)).astype(np.float32)
    d = r.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    parts = (tri[None, :, 0], tri[None, :, 1] - tri[None, :, 0],
             tri[None, :, 2] - tri[None, :, 0])
    want = jtrace.ray_tri_intersect(*map(jnp.asarray, parts),
                                    jnp.asarray(org), jnp.asarray(d))
    got = ttrace.ray_tri_intersect(*map(torch.as_tensor, parts),
                                   torch.as_tensor(org), torch.as_tensor(d))
    assert bool(np.asarray(want[3]).any())
    hit = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), hit)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-5)
