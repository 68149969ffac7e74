"""On-card tests of the port's CUDA kernel against its plain torch version.

Marked ``gpu``: they need a CUDA card and skip without one.  On the card:
``python -m pytest tests/ -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    trace_cuda.build()
    return torch.device('cuda')


def _soup(n, seed):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-10, 10, (n, 3)).astype(np.float32)
    e = r.uniform(-3.0, 3.0, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def _rays(n, seed, dev):
    r = np.random.default_rng(seed)
    org = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(org, device=dev), torch.as_tensor(d, device=dev)


def _kernel_vs_plain(b, org, d, t0, ig, ig2, any_hit):
    """Kernel and plain version on the same card and inputs: prim and slot
    identical on >= 99.9% of rays (both round the same expressions;
    -fmad=false), t within rtol 1e-6 where prim agrees; two launches of
    the kernel bit-identical; occluded_tris the any-hit flag."""
    key = 'any' if any_hit else 'closest'
    before = dict(trace_cuda.launches)
    k = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit)
    again = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit)
    torch.cuda.synchronize()
    assert trace_cuda.launches[key] == before[key] + 2
    for x, y in zip(k, again):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    assert k[1].dtype == k[4].dtype == torch.int64
    p = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                       org, d, t0, ig, ig2, any_hit=any_hit)
    if any_hit:
        flag = trace_cuda.occluded_tris(b, org, d, t0, ig, ig2)
        assert flag.dtype == torch.bool and torch.equal(flag, k[1] >= 0)
    k = [x.cpu().numpy() for x in k]
    p = [x.cpu().numpy() for x in p]
    assert (k[1] == p[1]).mean() >= 0.999
    assert (k[4] == p[4]).mean() >= 0.999
    agree = (k[1] == p[1]) & (k[1] >= 0)
    if not any_hit:
        np.testing.assert_allclose(k[0][agree], p[0][agree], rtol=1e-6)
        np.testing.assert_allclose(k[2][agree], p[2][agree], atol=1e-6)
        np.testing.assert_allclose(k[3][agree], p[3][agree], atol=1e-6)
    return k, p


@pytest.mark.parametrize('n_tris,n_rays', [(700, 300), (20000, 65536)])
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_matches_plain(cuda, n_tris, n_rays, any_hit):
    geom = ttrace.make_device_geometry(tri_v=_soup(n_tris, 11), device=cuda)
    b = geom.tri_bvh
    org, d = _rays(n_rays, 4, cuda)
    t0 = torch.where(torch.arange(n_rays, device=cuda) % 3 == 0,
                     torch.tensor(8.0, device=cuda),
                     torch.tensor(3.0e38, device=cuda))
    t0[:17] = 0.0                                   # dead lanes
    ig = torch.full((n_rays,), -1, dtype=torch.int32, device=cuda)
    ig[100:200] = 3
    ig2 = torch.flip(ig, [0]).contiguous()
    k, p = _kernel_vs_plain(b, org, d, t0, ig, ig2, any_hit)
    assert (k[1][:17] == -1).all() and (k[0][:17] == 0.0).all()
    if not any_hit:
        assert ((k[1] == p[1]) & (k[1] >= 0)).mean() > 0.1


@pytest.mark.parametrize('dead', [0.0, 0.5, 0.93, 1.0])
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_with_dead_lanes(cuda, dead, any_hit):
    """The persistent launch skips dead lanes (t_init <= 0) at fetch and
    compacts the live ones: same answers as the plain walk at 0%, 50%, 93%
    and 100% dead lanes, int64 ignore ids."""
    geom = ttrace.make_device_geometry(tri_v=_soup(20000, 11), device=cuda)
    n = 40000
    org, d = _rays(n, 7, cuda)
    g = torch.Generator().manual_seed(3)
    live = (torch.rand(n, generator=g) >= dead).to(cuda)
    t0 = torch.where(live, 9.0 if any_hit else 3.0e38, 0.0)
    ig = torch.full((n,), -1, dtype=torch.int64, device=cuda)
    k, p = _kernel_vs_plain(geom.tri_bvh, org, d, t0, ig, None, any_hit)
    dead_lanes = ~live.cpu().numpy()
    assert (k[1][dead_lanes] == -1).all() and (k[4][dead_lanes] == -1).all()
    assert (k[0][dead_lanes] == 0.0).all() and (k[2][dead_lanes] == 0.0).all()
    if dead < 1.0:
        assert (k[1] >= 0).any()


@pytest.mark.parametrize('n', [1, 127, 128, 129, 700000])
def test_kernel_ray_counts(cuda, n):
    """Ragged ray counts, and one above a pass of the persistent grid (6
    blocks of 128 threads on each of the card's SMs); t_init as one float
    and no ignore ids."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 700000 > sms * 6 * 128
    geom = ttrace.make_device_geometry(tri_v=_soup(700, 11), device=cuda)
    org, d = _rays(n, 8, cuda)
    for any_hit in (False, True):
        _kernel_vs_plain(geom.tri_bvh, org, d, 25.0, None, None, any_hit)


@pytest.mark.parametrize('depth', [None, 64, 192])
def test_kernel_stack_depths(cuda, depth):
    """The stack's shared memory is sized per launch from stack_depth: the
    tree's own need, a deeper setting (32 KB a block), and the limit of 192
    entries (96 KB a block, above the 48 KB default)."""
    import dataclasses
    geom = ttrace.make_device_geometry(tri_v=_soup(5000, 5), device=cuda)
    b = geom.tri_bvh
    assert 8 < b.stack_depth < 64
    if depth is not None:
        b = dataclasses.replace(b, stack_depth=depth)
    org, d = _rays(30000, 9, cuda)
    for any_hit in (False, True):
        _kernel_vs_plain(b, org, d, 3.0e38, None, None, any_hit)
    with pytest.raises(ValueError):
        trace_cuda.traverse_tris(dataclasses.replace(b, stack_depth=193),
                                 org, d, 3.0e38)


def test_kernel_rejects_bad_inputs(cuda):
    geom = ttrace.make_device_geometry(tri_v=_soup(50, 1), device=cuda)
    b = geom.tri_bvh
    org, d = _rays(64, 2, cuda)
    t0 = torch.full((64,), 1e30, device=cuda)
    ig = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        trace_cuda.traverse_tris(b, org, d, t0, ig.float())
    with pytest.raises(ValueError):
        trace_cuda.traverse_tris(b, org.t().contiguous().t(), d, t0, ig)
    with pytest.raises(ValueError):
        trace_cuda.traverse_tris(b, org.cpu(), d, t0, ig)
    import dataclasses
    with pytest.raises(ValueError):      # a BVH without the kernel's layout
        trace_cuda.traverse_tris(dataclasses.replace(b, knodes=None), org, d,
                                 t0, ig)


@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_counters_match_plain(cuda, any_hit):
    """want_counters: the kernel's per-block inner and leaf pops equal the
    plain walk's on every block (both count the same per-ray walk), the
    hit outputs agree as above, and only the 'counters' launch count
    moves."""
    geom = ttrace.make_device_geometry(tri_v=_soup(20000, 11), device=cuda)
    b = geom.tri_bvh
    n = 65536 + 300                                 # a ragged last block
    org, d = _rays(n, 6, cuda)
    t0 = torch.full((n,), 3.0e38, device=cuda)
    t0[::5] = 6.0
    t0[:40] = 0.0
    ig = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    before = dict(trace_cuda.launches)
    k = trace_cuda.traverse_tris(b, org, d, t0, ig, any_hit=any_hit,
                                 want_counters=True)
    torch.cuda.synchronize()
    assert trace_cuda.launches['counters'] == before['counters'] + 1
    assert trace_cuda.launches['closest'] == before['closest']
    assert trace_cuda.launches['any'] == before['any']
    p = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                       org, d, t0, ig, any_hit=any_hit,
                                       want_counters=True)
    k = [x.cpu().numpy() for x in k]
    p = [x.cpu().numpy() for x in p]
    assert k[5].shape == k[6].shape == (65,) and k[5].dtype == np.int32
    np.testing.assert_array_equal(k[5], p[5])
    np.testing.assert_array_equal(k[6], p[6])
    assert (k[5] > 0).all() and (k[6] > 0).all()
    assert (k[1] == p[1]).mean() >= 0.999
    plain5 = trace_cuda.traverse_tris(b, org, d, t0, ig, any_hit=any_hit)
    np.testing.assert_array_equal(plain5[1].cpu().numpy(), k[1])


# --- the forms that replace XLA's skip-link _traverse ------------------------

def _mixed_geometry(dev, n, seed):
    """n moving triangles, n spheres and n lines in one [-10, 10]^3 box."""
    g = np.random.default_rng(seed)
    tri = _soup(n, seed)
    a = g.uniform(-10, 10, (n, 3)).astype(np.float32)
    return ttrace.make_device_geometry(
        tri_v=tri,
        tri_v_t1=tri + g.uniform(-1, 1, (n, 1, 3)).astype(np.float32),
        sph_c=g.uniform(-10, 10, (n, 3)).astype(np.float32),
        sph_r=g.uniform(0.05, 0.4, n).astype(np.float32),
        line_vtx=np.stack([a, a + g.uniform(-2, 2, (n, 3)).astype(np.float32)],
                          axis=1),
        line_radii=g.uniform(0.02, 0.2, (n, 2)).astype(np.float32),
        device=dev)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _form_vs_plain(target, kind, key, dev, offset, any_hit, n=40000):
    """One form against its plain version on the card: closest-hit (or
    any-hit) with dead lanes, bounded segments, ignore ids taken from a
    first pass, ray times and a carried-in running hit; prim (blocked)
    equal on >= 99.9% of rays and t within rtol 1e-6 where prim agrees
    (both sides round the same expressions, -fmad=false; a difference is
    an exact-t tie between leaves visited in another order); two launches
    bit-identical; only this form's launch count moves."""
    org, d = _rays(n, 17, dev)
    g = torch.Generator().manual_seed(3)
    time = torch.rand(n, generator=g).to(dev)
    t0 = torch.full((n,), 3.0e38, device=dev)
    t0[::5] = 8.0
    t0[:64] = 0.0
    first = trace_cuda.closest_hit_plain(target, kind, org, d, t0, time=time,
                                         prim_offset=offset)
    assert (first[1] >= 0).float().mean() > 0.05
    ig = torch.where(torch.arange(n, device=dev) % 3 == 0, first[1], -1)
    kw = dict(time=time, prim_offset=offset)
    before = dict(trace_cuda.launches)
    if any_hit:
        carry = (torch.rand(n, generator=g) < 0.2).to(dev)
        runs = [trace_cuda.any_hit(target, kind, org, d, t0, ig, ig,
                                   carry=c, **kw)
                for c in (None, None, carry.clone(), carry.clone())]
        plain = [trace_cuda.any_hit_plain(target, kind, org, d, t0, ig, ig,
                                          carry=c, **kw)
                 for c in (None, carry)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[2], runs[3])
        for k, p in zip(runs[::2], plain):
            assert k.dtype == torch.bool and p.any()
            assert (k == p).float().mean() >= 0.999
        assert not runs[0][:64].any()       # dead lanes
        assert (runs[2] | ~carry).all()     # a blocked lane stays blocked
    else:
        f32 = dict(dtype=torch.float32, device=dev)
        carry = (torch.where(torch.rand(n, generator=g).to(dev) < 0.5,
                             torch.rand(n, generator=g).to(dev) * 20.0, t0),
                 torch.full((n,), 7, dtype=torch.int64, device=dev),
                 torch.full((n,), 0.25, **f32), torch.full((n,), 0.5, **f32),
                 torch.full((n,), 3, dtype=torch.int64, device=dev))
        clone = lambda c: tuple(x.clone() for x in c)
        runs = [trace_cuda.closest_hit(target, kind, org, d, t0, ig, carry=c,
                                       **kw)
                for c in (None, None, clone(carry), clone(carry))]
        plain = [trace_cuda.closest_hit_plain(target, kind, org, d, t0, ig,
                                              carry=c, **kw)
                 for c in (None, carry)]
        torch.cuda.synchronize()
        for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
            assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))
        for k, p in zip(runs[::2], plain):
            same = k[1] == p[1]
            assert same.float().mean() >= 0.999
            torch.testing.assert_close(k[0][same], p[0][same], rtol=1e-6,
                                       atol=0)
            for x, y in zip(k[2:], p[2:]):          # u, v, slot
                assert (x[same] == y[same]).float().mean() >= 0.999
        k = runs[0]
        assert (k[1][:64] == -1).all() and (k[0][:64] == 0).all()
        hit = k[1] >= 0
        assert (k[1][hit] >= offset).all() and not (k[1] == ig)[hit].any()
        # lanes the carried hit already wins keep all five of its values
        kept = runs[2][0] == carry[0]
        assert (runs[2][1][kept] == 7).all() and (runs[2][4][kept] == 3).all()
    moved = {k for k in before if trace_cuda.launches[k] != before[k]}
    assert moved == {key} and trace_cuda.launches[key] == before[key] + 4


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('kind', ['tri', 'moving', 'sphere', 'line'])
def test_wide_forms_match_plain(cuda, kind, any_hit):
    """The wide walk with each leaf policy; the static triangles ('tri')
    count as the TPU kernel's 'closest' / 'any'."""
    geom = _mixed_geometry(cuda, 20000, 21)
    target, offset = {'tri': (geom.tri_bvh, 0), 'moving': (geom.tri_bvh, 0),
                      'sphere': (geom.sph_bvh, 20000),
                      'line': (geom.line_bvh, 40000)}[kind]
    assert target.knodes is not None
    mode = 'any' if any_hit else 'closest'
    _form_vs_plain(target, kind, mode if kind == 'tri' else f'{kind}_{mode}',
                   cuda, offset, any_hit)


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('kind', ['tri', 'moving', 'sphere', 'line'])
def test_deep_form_matches_plain(cuda, monkeypatch, kind, any_hit):
    """A tree without a wide layout (the stack limit patched down to 8
    entries at upload) is walked by its skip links."""
    monkeypatch.setattr(trace_cuda, 'MAX_STACK', 8)
    geom = _mixed_geometry(cuda, 5000, 22)
    target, offset = {'tri': (geom.tri_bvh, 0), 'moving': (geom.tri_bvh, 0),
                      'sphere': (geom.sph_bvh, 5000),
                      'line': (geom.line_bvh, 10000)}[kind]
    assert target.knodes is None and target.wbounds is None
    _form_vs_plain(target, kind, f'deep_{"any" if any_hit else "closest"}',
                   cuda, offset, any_hit)


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('kind', ['sphere', 'moving sphere', 'line'])
def test_dense_forms_match_plain(cuda, kind, any_hit):
    """The dense list of at most 64 prims: the geometry's own arrays, no
    tree; sphere centres lerped at the ray time when c_t1 is given."""
    g = np.random.default_rng(5)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    c = g.uniform(-8, 8, (64, 3))
    if kind == 'line':
        target = (T(c), T(c + g.uniform(-3, 3, (64, 3))),
                  T(g.uniform(0.2, 1, 64)), T(g.uniform(0.2, 1, 64)))
    else:
        target = (T(c), T(g.uniform(0.5, 2, 64)),
                  T(c + g.uniform(-2, 2, (64, 3))) if 'moving' in kind
                  else None)
    kind = kind.split()[-1]
    _form_vs_plain(target, kind,
                   f'dense_{kind}_{"any" if any_hit else "closest"}', cuda,
                   1000, any_hit)


def test_forms_reject_bad_inputs(cuda):
    import dataclasses
    geom = _mixed_geometry(cuda, 200, 23)
    org, d = _rays(64, 2, cuda)
    time = torch.rand(64, device=cuda)
    t0 = torch.full((64,), 1e30, device=cuda)
    hit = trace_cuda.closest_hit(geom.sph_bvh, 'sphere', org, d, t0)
    dense = (geom.sph_c[:64].contiguous(), geom.sph_r[:64].contiguous(), None)
    with pytest.raises(ValueError):      # moving triangles without a time
        trace_cuda.closest_hit(geom.tri_bvh, 'moving', org, d, t0)
    with pytest.raises(TypeError):
        trace_cuda.closest_hit(geom.tri_bvh, 'moving', org, d, t0,
                               time=time.double())
    with pytest.raises(ValueError):      # the rows of another kind
        trace_cuda.closest_hit(geom.sph_bvh, 'line', org, d, t0)
    with pytest.raises(ValueError):      # a BVH without the kernel's rows
        trace_cuda.any_hit(dataclasses.replace(geom.line_bvh, kleaves=None),
                           'line', org, d, t0)
    with pytest.raises(ValueError):      # a list too long for the dense form
        trace_cuda.closest_hit((geom.sph_c[:65].contiguous(),
                                geom.sph_r[:65].contiguous(), None), 'sphere',
                               org, d, t0)
    with pytest.raises(ValueError):      # a running hit of another length
        trace_cuda.closest_hit(dense, 'sphere', org, d, t0,
                               carry=tuple(x[:32] for x in hit))
    with pytest.raises(TypeError):       # blocked flags that are not bool
        trace_cuda.any_hit(dense, 'sphere', org, d, t0,
                           carry=torch.zeros(64, device=cuda))
    with pytest.raises(ValueError):      # list arrays on another device
        trace_cuda.any_hit((dense[0].cpu(), dense[1], None), 'sphere', org, d,
                           t0)


def test_intersect_mixed_scene_on_the_card(cuda):
    """trace.intersect / occluded on triangles, spheres and lines at once:
    the card's kernels against the CPU's plain versions of the same
    geometry (prim and blocked equal on >= 99.9% of rays), one launch a
    prim kind."""
    geoms = [_mixed_geometry(dev, 3000, 24) for dev in (cuda, 'cpu')]
    org, d = _rays(30000, 9, cuda)
    time = torch.rand(30000, device=cuda)
    t_max = torch.full((30000,), 12.0, device=cuda)
    before = dict(trace_cuda.launches)
    hk = ttrace.intersect(geoms[0], org, d, time=time)
    bk = ttrace.occluded(geoms[0], org, d, t_max, time=time)
    torch.cuda.synchronize()
    moved = {k: trace_cuda.launches[k] - before[k] for k in before
             if trace_cuda.launches[k] != before[k]}
    assert moved == {f'{k}_{m}': 1 for k in ('moving', 'sphere', 'line')
                     for m in ('closest', 'any')}
    hp = ttrace.intersect(geoms[1], org.cpu(), d.cpu(), time=time.cpu())
    bp = ttrace.occluded(geoms[1], org.cpu(), d.cpu(), t_max.cpu(),
                         time=time.cpu())
    assert (hk.prim.cpu() == hp.prim).float().mean() >= 0.999
    assert (bk.cpu() == bp).float().mean() >= 0.999
    for lo, hi in ((0, 3000), (3000, 6000), (6000, 9000)):   # every kind hit
        assert ((hp.prim >= lo) & (hp.prim < hi)).any()
