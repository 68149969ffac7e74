"""On-card tests of the port's CUDA kernel against its plain torch version.

Marked ``gpu``: they need a CUDA card and skip without one.  On the card:
``python -m pytest tests/ -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from corona13_tpu_torch import tracing
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
    the kernel bit-identical; any_hit's launch the any-hit flag."""
    key = 'any' if any_hit else 'closest'
    before = dict(tracing.launches)
    k = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit)
    again = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit)
    torch.cuda.synchronize()
    assert tracing.launches[key] == before[key] + 2
    for x, y in zip(k, again):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    assert k[1].dtype == k[4].dtype == torch.int64
    p = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                       org, d, t0, ig, ig2, any_hit=any_hit)
    if any_hit:
        before = tracing.launches['any']
        flag = trace_cuda.any_hit(b, 'tri', org, d, t0, ig, ig2)
        assert tracing.launches['any'] == before + 1
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


def _union_vs_plain(b, org, d, t0, ig, any_hit, ig2=None):
    """union_kernel (traverse_tris with want_counters) against
    union_walk_plain on the same card and inputs: the per-block counts and
    every bit of (t, prim, u, v, slot) equal, two launches bit-identical,
    and only the 'counters' launch count moves.  Returns the outputs."""
    before = dict(tracing.launches)
    k = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit,
                                 want_counters=True)
    again = trace_cuda.traverse_tris(b, org, d, t0, ig, ig2, any_hit=any_hit,
                                     want_counters=True)
    torch.cuda.synchronize()
    moved = {key: tracing.launches[key] - before[key] for key in before
             if tracing.launches[key] != before[key]}
    assert moved == {'counters': 2}
    n_blocks = -(-org.shape[0] // trace_cuda.BLOCK)
    assert k[5].shape == k[6].shape == (n_blocks,)
    assert k[5].dtype == k[6].dtype == torch.int32
    assert k[1].dtype == k[4].dtype == torch.int64
    for x, y in zip(k, again):
        assert torch.equal(_bits(x), _bits(y))
    p = trace_cuda.union_walk_plain(b.wbounds, b.wlinks, b.leaf_packed, org,
                                    d, t0, ig, ig2, any_hit=any_hit)
    for name, x, y in zip(('t', 'prim', 'u', 'v', 'slot', 'iters', 'leafs'),
                          k, p):
        assert torch.equal(_bits(x), _bits(y)), name
    return [x.cpu().numpy() for x in k]


@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_counters_match_plain(cuda, any_hit):
    """want_counters: the union kernel's per-block inner and leaf pops and
    its hits equal the plain union walk's on a 20,000-triangle soup, with
    a ragged last block, dead lanes and short segments."""
    geom = ttrace.make_device_geometry(tri_v=_soup(20000, 11), device=cuda)
    b = geom.tri_bvh
    n = 65536 + 300                                 # a ragged last block
    org, d = _rays(n, 6, cuda)
    t0 = torch.full((n,), 3.0e38, device=cuda)
    t0[::5] = 6.0
    t0[:40] = 0.0
    ig = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    k = _union_vs_plain(b, org, d, t0, ig, any_hit)
    assert k[5].shape == (65,)
    assert (k[5] > 0).all() and (k[6] > 0).all()


def test_kernel_counters_blocked_shadow_tiles(cuda):
    """Full tiles of shadow segments, some blocked and some not, with both
    ignore ids set: the union kernel equals the plain union walk, and the
    per-ray walk (simple_walk, counted as 'tri_counters') gives each ray's
    own pops as the plain per-ray walk counts them."""
    geom = ttrace.make_device_geometry(tri_v=_soup(20000, 12), device=cuda)
    b = geom.tri_bvh
    n = 8 * trace_cuda.BLOCK
    org, d = _rays(n, 7, cuda)
    g = torch.Generator(device='cpu').manual_seed(3)
    t0 = (0.2 + 6.0 * torch.rand(n, generator=g)).to(cuda)
    ig = torch.randint(0, 20000, (n,), generator=g).to(cuda)
    ig2 = torch.randint(0, 20000, (n,), generator=g).to(cuda)
    k = _union_vs_plain(b, org, d, t0, ig, True, ig2)
    blocked = (k[1] >= 0).reshape(-1, 128)
    assert (blocked.any(axis=1) & ~blocked.all(axis=1)).all()
    before = dict(tracing.launches)
    s = trace_cuda.simple_walk(b, org, d, t0, ig, ig2, any_hit=True)
    torch.cuda.synchronize()
    assert tracing.launches['tri_counters'] == before['tri_counters'] + 1
    assert tracing.launches['counters'] == before['counters']
    p = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                       org, d, t0, ig, ig2, any_hit=True,
                                       ray_pops=True)
    assert torch.equal(s[1] >= 0, p[1] >= 0)
    assert torch.equal(s[5], p[5]) and torch.equal(s[6], p[6])
    np.testing.assert_array_equal(s[1].cpu().numpy() >= 0, k[1] >= 0)


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
    before = dict(tracing.launches)
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
    moved = {k for k in before if tracing.launches[k] != before[k]}
    assert moved == {key} and tracing.launches[key] == before[key] + 4


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
    assert target.bnodes is not None
    _form_vs_plain(target, kind, f'deep_{"any" if any_hit else "closest"}',
                   cuda, offset, any_hit)


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('kind', ['tri', 'moving', 'sphere', 'line'])
def test_skip_form_matches_plain(cuda, monkeypatch, kind, any_hit):
    """A tree too deep for the wide stack and for the deep walk's (both
    limits patched down at upload) is walked by its skip links
    (skip_kernel), counted as 'skip_*'."""
    monkeypatch.setattr(trace_cuda, 'MAX_STACK', 8)
    monkeypatch.setattr(trace_cuda, 'MAX_BIN_STACK', 4)
    geom = _mixed_geometry(cuda, 5000, 22)
    target, offset = {'tri': (geom.tri_bvh, 0), 'moving': (geom.tri_bvh, 0),
                      'sphere': (geom.sph_bvh, 5000),
                      'line': (geom.line_bvh, 10000)}[kind]
    assert target.knodes is None and target.bnodes is None
    assert trace_cuda._form_of(target, kind) == 'skip'
    _form_vs_plain(target, kind, f'skip_{"any" if any_hit else "closest"}',
                   cuda, offset, any_hit)


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('kind', ['sphere', 'moving sphere', 'line'])
def test_dense_forms_match_plain(cuda, kind, any_hit):
    """The dense list of at most 64 prims, no tree: spheres from the
    geometry's own arrays, their centres lerped at the ray time when c_t1
    is given; lines from their records with each line's terms packed on
    the card (trace_cuda.pack_dense_lines)."""
    g = np.random.default_rng(5)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    c = g.uniform(-8, 8, (64, 3))
    if kind == 'line':
        target = (trace_cuda.pack_dense_lines(
            T(c), T(c + g.uniform(-3, 3, (64, 3))), T(g.uniform(0.2, 1, 64)),
            T(g.uniform(0.2, 1, 64))),)
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


def test_line_form_at_hair_shapes(cuda):
    """Both line instantiations (line_closest, line_any) at the hair
    frame's shapes: chip_smoke.py's 65,536-fibre hair scene, every line
    launch of one 1024x576 progression captured from its own intersect /
    occluded calls and launched again on the same tensors, twice
    bit-identical and against the plain walk (prim and blocked on >=
    99.9% of rays, t rtol 1e-6 where prim agrees: chip_smoke._form_compare);
    and the line counters launch on the first bounce's rays against the
    same plain walk."""
    import importlib.util
    import os
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    spec = importlib.util.spec_from_file_location('chip_smoke', os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hair = scene_mod.fit_film(cs._hair_scene(cuda), 1024, 576)
    cfg = pt_mod.PTConfig(width=1024, height=576, max_verts=6, mf=4,
                          use_nee=True)
    kept = cs.frame_calls(hair, cfg)
    lines = {m: [c for c in calls if c[1] == 'line']
             for m, calls in kept.items()}
    assert all(len(c) == cfg.max_verts - 1 for c in lines.values())
    out = cs._hold_calls('hair frame', lines)
    assert set(out) == {'line_closest', 'line_any'}
    target, _, args, kw = lines['closest_hit'][0]
    before = tracing.launches['line_counters']
    pops = cs.line_counts('hair first bounce', target, kw['prim_offset'],
                          'closest', (args[0], args[1], kw['carry'][0],
                                      args[3], None), 'the card',
                          time_it=False)
    assert tracing.launches['line_counters'] == before + 1
    assert 0 < pops['leaf_per_ray'] <= pops['plain_leaves_per_ray']


def _smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location('chip_smoke', os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize('any_hit', [False, True])
def test_moving_form_at_0002_mb_shapes(cuda, any_hit):
    """One moving instantiation (moving_closest or moving_any) at the
    0002_mb frame's shapes: every moving launch of one 1024x576
    progression captured from the frame's own calls and launched again on
    the same tensors, twice bit-identical and against the plain walk
    (chip_smoke._hold_calls, which holds the moving form bit for bit);
    then, bit for bit on every ray, on every captured launch and on rays
    aimed at the edges two leaves of the plane share (chip_smoke.
    edge_rays), where a tie or a hit an ulp before its box is decided by
    the reference's walk order."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    cs = _smoke()
    mb = scene_mod.fit_film(scene_mod.load_scene(
        cs._scene_path('0002_mb'), device=cuda)[0], 1024, 576)
    cfg = pt_mod.PTConfig(width=1024, height=576, max_verts=6, mf=4,
                          use_nee=True)
    mode = 'any_hit' if any_hit else 'closest_hit'
    calls = [c for c in cs.frame_calls(mb, cfg)[mode] if c[1] == 'moving']
    assert len(calls) == cfg.max_verts - 1
    key = 'moving_any' if any_hit else 'moving_closest'
    assert set(cs._hold_calls('0002_mb frame', {mode: calls})) == {key}
    tup = (lambda x: (x,)) if any_hit else (lambda x: x)
    for target, kind, args, kw in calls:
        k = getattr(trace_cuda, mode)(target, kind, *args, **cs._cloned(kw))
        p = getattr(trace_cuda, mode + '_plain')(target, kind, *args,
                                                 **cs._cloned(kw))
        for x, y in zip(tup(k), tup(p)):
            assert torch.equal(_bits(x), _bits(y))
    edges = cs.edge_forms('0002_mb', mb.geom.tri_bvh, 'moving',
                          cs.edge_rays(mb.geom, 1 << 14, 21, cuda),
                          'the card')
    assert edges[mode]['differ'] == 0 and edges[mode]['hit_share'] > 0.3


@pytest.mark.parametrize('any_hit', [False, True])
def test_sphere_form_at_sphere_frame_shapes(cuda, any_hit):
    """One sphere instantiation (sphere_closest or sphere_any) at the
    shapes of chip_smoke.py's sphere frame (65,536 spheres): every sphere
    launch of one 1024x576 progression captured and launched again on the
    same tensors, bit for bit against the plain walk (t, prim, u, v, slot;
    the blocked flag); then on rays aimed at points two spheres of
    different leaves share (chip_smoke.sphere_edge_rays), where the walk's
    order decides a tie or a hit an ulp before its box."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    cs = _smoke()
    sc = scene_mod.fit_film(cs._sphere_scene(cuda), 1024, 576)
    cfg = pt_mod.PTConfig(width=1024, height=576, max_verts=6, mf=4,
                          use_nee=True)
    mode = 'any_hit' if any_hit else 'closest_hit'
    calls = [c for c in cs.frame_calls(sc, cfg)[mode] if c[1] == 'sphere']
    assert len(calls) == cfg.max_verts - 1
    tup = (lambda x: (x,)) if any_hit else (lambda x: x)
    for target, kind, args, kw in calls:
        k = getattr(trace_cuda, mode)(target, kind, *args, **cs._cloned(kw))
        p = getattr(trace_cuda, mode + '_plain')(target, kind, *args,
                                                 **cs._cloned(kw))
        for x, y in zip(tup(k), tup(p)):
            assert torch.equal(_bits(x), _bits(y))
    edges = cs.sphere_edges({'spheres': sc.geom}, 'the card', strict=True)
    assert edges['spheres'][mode]['differ'] == 0
    assert edges['spheres'][mode]['hit_share'] > 0.3


def test_deep_form_on_edge_rays(cuda):
    """The plane scene's static tree and the zoom frame's tree
    (chip_smoke._zoom_scene, too deep for the wide stack) without a wide
    layout, walked by the deep walk (deep_kernel) and by skip links
    (skip_kernel, laid out as a tree over the deep stack's limit), on rays
    aimed at edges two of their leaves share (chip_smoke.edge_rays):
    closest-hit and any-hit equal the plain skip-link walk bit for bit."""
    from corona13_tpu_torch import testing
    cs = _smoke()
    out = cs.plane_edges_phase(testing.plane_scene(device=cuda), 'the card')
    zoom = cs._zoom_scene(cuda).geom
    org, d, _, seg = cs.edge_rays(zoom, 1 << 16, 21, cuda)
    for form, tree in (('deep', zoom.tri_bvh),
                       ('skip', cs._skip_tree(zoom.tri_bvh))):
        got = cs.edge_forms('zoom', tree, 'tri', (org, d, None, seg),
                            'the card')
        for mode in ('closest_hit', 'any_hit'):
            for where in (out[form], got):
                assert where[mode]['differ'] == 0
                assert where[mode]['hit_share'] > 0.3


@pytest.mark.parametrize('any_hit', [False, True])
def test_deep_form_at_zoom_frame_shapes(cuda, any_hit):
    """deep_closest or deep_any at the shapes of chip_smoke.py's zoom frame
    (65,536 triangles in a log-spiral ribbon: wdepth 31, no wide layout):
    every deep launch of one 1024x576 progression captured and launched
    again on the same tensors, bit for bit against the plain walk (t, prim,
    u, v, slot; the blocked flag), and the same launches by the skip form
    of the tree (laid out as a tree over the deep stack's limit)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    cs = _smoke()
    sc = scene_mod.fit_film(cs._zoom_scene(cuda), 1024, 576)
    assert trace_cuda._form_of(sc.geom.tri_bvh, 'tri') == 'deep'
    cfg = pt_mod.PTConfig(width=1024, height=576, max_verts=6, mf=4,
                          use_nee=True)
    mode = 'any_hit' if any_hit else 'closest_hit'
    calls = cs.frame_calls(sc, cfg)[mode]
    assert len(calls) == cfg.max_verts - 1
    skip = cs._skip_tree(sc.geom.tri_bvh)
    tup = (lambda x: (x,)) if any_hit else (lambda x: x)
    before = dict(tracing.launches)
    for target, kind, args, kw in calls:
        p = getattr(trace_cuda, mode + '_plain')(target, kind, *args,
                                                 **cs._cloned(kw))
        for tree in (target, skip):
            k = getattr(trace_cuda, mode)(tree, kind, *args, **cs._cloned(kw))
            for x, y in zip(tup(k), tup(p)):
                assert torch.equal(_bits(x), _bits(y))
    m = 'any' if any_hit else 'closest'
    moved = {k: v - before[k] for k, v in tracing.launches.items()
             if v != before[k]}
    assert moved == {f'deep_{m}': 5, f'skip_{m}': 5}


def test_moving_records_on_the_card(cuda):
    """The moving records the card carries: what pack_moving_rows gives
    for the tree's leaf_data / leaf_data_t1 (12 moving rows on 0002_mb),
    and the preorder push weights of pack_nodes."""
    from corona13_tpu_torch import scene as scene_mod
    cs = _smoke()
    b = scene_mod.load_scene(cs._scene_path('0002_mb'),
                             device=cuda)[0].geom.tri_bvh
    kl, kl1 = trace_cuda.pack_moving_rows(b.leaf_data.cpu().numpy(),
                                          b.leaf_data_t1.cpu().numpy(),
                                          b.leaf_prims.cpu().numpy())
    assert torch.equal(_bits(b.kleaves.cpu()), _bits(torch.as_tensor(kl)))
    assert torch.equal(_bits(b.kleaves_t1.cpu()), _bits(torch.as_tensor(kl1)))
    assert tuple(b.kleaves_t1.shape) == (12, 12)
    kn = trace_cuda.pack_nodes(b.wbounds.cpu().numpy(),
                               b.wlinks.cpu().numpy())
    assert torch.equal(_bits(b.knodes.cpu()), _bits(torch.as_tensor(kn)))


def test_intersect_mixed_scene_on_the_card(cuda):
    """trace.intersect / occluded on triangles, spheres and lines at once:
    the card's kernels against the CPU's plain versions of the same
    geometry (prim and blocked equal on >= 99.9% of rays), one launch a
    prim kind."""
    geoms = [_mixed_geometry(dev, 3000, 24) for dev in (cuda, 'cpu')]
    org, d = _rays(30000, 9, cuda)
    time = torch.rand(30000, device=cuda)
    t_max = torch.full((30000,), 12.0, device=cuda)
    before = dict(tracing.launches)
    hk = ttrace.intersect(geoms[0], org, d, time=time)
    bk = ttrace.occluded(geoms[0], org, d, t_max, time=time)
    torch.cuda.synchronize()
    moved = {k: tracing.launches[k] - before[k] for k in before
             if tracing.launches[k] != before[k]}
    assert moved == {f'{k}_{m}': 1 for k in ('moving', 'sphere', 'line')
                     for m in ('closest', 'any')}
    hp = ttrace.intersect(geoms[1], org.cpu(), d.cpu(), time=time.cpu())
    bp = ttrace.occluded(geoms[1], org.cpu(), d.cpu(), t_max.cpu(),
                         time=time.cpu())
    assert (hk.prim.cpu() == hp.prim).float().mean() >= 0.999
    assert (bk.cpu() == bp).float().mean() >= 0.999
    for lo, hi in ((0, 3000), (3000, 6000), (6000, 9000)):   # every kind hit
        assert ((hp.prim >= lo) & (hp.prim < hi)).any()


# --- skies, compaction and gradients on the card against the CPU ------------

def _moved(before):
    """Launches by key since ``before``, the counter RNG's draws aside:
    every such call draws on the card (at least one 'rng_uniform')."""
    moved = {k: v - before[k] for k, v in tracing.launches.items()
             if v != before[k]}
    assert moved.pop('rng_uniform', 0) > 0, moved
    return moved


def _paths_on_both(build, cfg, cuda, sample=5):
    """sample_paths of ``build(device)`` on the card and on the CPU: the
    share of paths equal at rtol 1e-4 / atol 1e-6, and the card's launch
    counts of that call, the RNG's aside."""
    from corona13_tpu_torch.samplers import pt as pt_mod
    out = []
    for d in (cuda, torch.device('cpu')):
        before = dict(tracing.launches)
        pix = torch.arange(cfg.width * cfg.height, device=d)
        out.append(pt_mod.sample_paths(build(d), cfg, sample, pix)[0].cpu()
                   .numpy())
        if d is cuda:
            moved = _moved(before)
    close = np.isclose(out[0], out[1], rtol=1e-4, atol=1e-6).all(axis=-1)
    assert (out[1] > 0).any(axis=-1).mean() > 0.05
    return float(close.mean()), moved


def test_sky_frames_on_the_card(cuda):
    """An envmap frame (two any-hit launches a bounce) and a daylight
    frame: the card's paths equal the CPU's on >= 99%."""
    import dataclasses
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.models import daylight, envmap
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=5, mf=4)
    rgb = envmap.make_gradient_sky(sun_dir=(0.3, 0.2, 0.9), sun_radiance=200.0)
    env = envmap.build(rgb, device=cuda)
    assert env.coeff.is_cuda
    cpu_tables = dataclasses.replace(env, **{
        f.name: getattr(env, f.name).cpu() for f in dataclasses.fields(env)})

    def under_envmap(d):
        return dataclasses.replace(
            testing.plane_scene(device=d), has_envmap=True,
            envmap=env if d is cuda else cpu_tables)
    share, moved = _paths_on_both(under_envmap, cfg, cuda)
    assert share >= 0.99, share
    assert moved == {'closest': 4, 'any': 8}, moved

    def under_daylight(d):
        return dataclasses.replace(
            testing.plane_scene(device=d), has_daylight=True,
            daylight=daylight.build((0.3, 0.2, 0.9), 2.5, device=d))
    share, moved = _paths_on_both(under_daylight, cfg, cuda)
    assert share >= 0.99, share
    assert moved == {'closest': 4, 'any': 4}, moved
    # the bisection finds on the card what it finds on the CPU
    g = torch.Generator().manual_seed(3)
    r1, r2 = torch.rand(1 << 16, generator=g), torch.rand(1 << 16, generator=g)
    dc, _ = envmap.sample(env, r1.to(cuda), r2.to(cuda))
    dh, _ = envmap.sample(cpu_tables, r1, r2)
    assert ((dc.cpu() - dh).abs().amax(dim=-1) < 1e-5).float().mean() >= 0.995


def test_compacted_frame_on_the_card(cuda):
    """A capped wavefront: the same survivors on the card as on the CPU,
    and the kernels launched once a depth."""
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=5, mf=4,
                          compact=(1.0, 0.8, 0.7, 0.6))
    share, moved = _paths_on_both(lambda d: testing.cornell_scene(device=d),
                                  cfg, cuda)
    assert share >= 0.99, share
    assert moved == {k: 4 for k in ('closest', 'any', 'dense_sphere_closest',
                                    'dense_sphere_any')}, moved


def test_gradient_on_the_card(cuda):
    """backward() through the kernels' launches (which record nothing):
    the card's gradient equals the CPU's to 5e-3 and central differences
    on the card to 2e-3."""
    import dataclasses
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=5, mf=4)
    grads = {}
    for d in (cuda, torch.device('cpu')):
        sc = testing.cornell_scene(device=d)

        def f(t):
            mats = dataclasses.replace(sc.materials, d_mul=sc.materials.d_mul * t)
            return pt_mod.render_sample(
                dataclasses.replace(sc, materials=mats), cfg, 0).mean()
        theta = torch.tensor(1.0, device=d, requires_grad=True)
        f(theta).backward()
        grads[d.type] = float(theta.grad)
        if d is cuda:
            with torch.no_grad():
                fd = (float(f(torch.tensor(1.001, device=d)))
                      - float(f(torch.tensor(0.999, device=d)))) / 0.002
    assert np.isfinite(grads['cuda']) and grads['cuda'] > 0
    assert abs(grads['cuda'] - grads['cpu']) <= 5e-3 * grads['cpu'], grads
    assert abs(grads['cuda'] - fd) <= 2e-3 * abs(fd), (grads, fd)


def test_splat_reproducible_on_the_card(cuda):
    """The general splat and the DBOR cascade: two launches on the card
    bit-identical (no atomics: a sorted segmented sum), and within 1e-6 of
    the largest pixel of the CPU's on the same samples."""
    from corona13_tpu_torch.ops import splat
    g = torch.Generator().manual_seed(8)
    n, w, h = 1 << 18, 256, 144
    pi = torch.rand(n, generator=g) * (w + 4) - 2
    pj = torch.rand(n, generator=g) * (h + 4) - 2
    pi[:4096], pj[:4096] = pi[0], pj[0]          # a hot pixel
    col = 10.0 ** (torch.rand(n, 3, generator=g) * 5 - 2)
    args = [x.to(cuda) for x in (pi, pj, col)]
    for kind in ('blackmanharris', 'box', 'bilin', 'dbor'):
        if kind == 'dbor':
            run = lambda a, b, c, d: splat.splat_dbor(
                torch.zeros(splat.N_DBOR, h, w, 3, device=d), a, b, c)
        else:
            run = lambda a, b, c, d: splat.splat(
                torch.zeros(h, w, 3, device=d), a, b, c, filter_kind=kind)
        first = run(*args, cuda)
        assert torch.equal(run(*args, cuda), first), kind
        cpu = run(pi, pj, col, torch.device('cpu'))
        err = float((first.cpu() - cpu).abs().max() / cpu.abs().max())
        assert err <= 1e-6 or (kind == 'dbor' and err <= 1e-5), (kind, err)


def _splat_inputs(n, w, h, seed, odd=True):
    """Splats over a film of w x h and its border: a hot pixel of 4,096
    splats, half the colours +0.0 or -0.0 (as bdpt's unconnected lanes);
    with ``odd``, coordinates that are NaN or inf, and NaN and inf colours,
    some at the hot pixel."""
    g = torch.Generator().manual_seed(seed)
    pi = torch.rand(n, generator=g) * (w + 4) - 2
    pj = torch.rand(n, generator=g) * (h + 4) - 2
    pi[:4096], pj[:4096] = pi[0], pj[0]
    col = 10.0 ** (torch.rand(n, 3, generator=g) * 5 - 2)
    dead = torch.rand(n, generator=g) < 0.5
    col[dead] = torch.where(torch.rand(n, 1, generator=g)[dead] < 0.5,
                            0.0, -0.0)
    col[5000, 1] = -0.0                            # one colour of three
    if odd:
        pi[6000:6004] = float('nan')
        pj[6004:6008] = float('inf')
        pi[6008:6012] = -float('inf')
        col[4000, 1] = col[7000, 0] = float('nan')
        col[4001, 2] = col[7001, 2] = float('inf')
    return pi, pj, col


_SPLAT_KINDS = ['box', 'bilin', 'blackmanharris', 'spline', 'gaussian',
                'dbor']


@pytest.mark.parametrize('kind', _SPLAT_KINDS)
def test_binned_scatter_equals_sort_path(cuda, kind):
    """The binned sum's ``_scatter`` against the sort path
    (``_scatter_sorted``), each called explicitly on the same card tensors,
    tap for tap as ``splat`` (or ``splat_dbor``) makes them from splats
    with a hot pixel, splats off the film and with coordinates that are not
    finite, +-0.0, NaN and inf colours: bit-equal; the same bits under a
    permutation of the splats, and on a second run."""
    from corona13_tpu_torch.ops import splat
    n, w, h = 1 << 18, 256, 144
    pi, pj, col = [x.to(cuda) for x in _splat_inputs(n, w, h, 8)]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    perm = perm.to(cuda)
    shape = (splat.N_DBOR, h, w, 3) if kind == 'dbor' else (h, w, 3)
    fb0 = torch.rand(shape, generator=torch.Generator().manual_seed(10))
    fb0[..., 0, :] = -0.0
    fb0 = fb0.to(cuda)

    def run(scatter, a, b, c):
        taps = (splat._dbor_taps(h, w, a, b, c) if kind == 'dbor'
                else splat._taps(h, w, a, b, c, kind))
        fb = fb0
        for t in taps:
            fb = scatter(fb, *t)
        return fb.view(torch.int32)
    want = run(splat._scatter_sorted, pi, pj, col)
    got = run(splat._scatter, pi, pj, col)
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(run(splat._scatter, pi[perm], pj[perm], col[perm]),
                       want)
    assert torch.equal(run(splat._scatter, pi, pj, col), want)


def test_binned_scatter_bins_of_every_size(cuda):
    """Box splats in bins of 1, 32 and 33 taps (one thread sorts at most
    32), 16,384 and 16,385 (a block sorts at most 16,384 in shared memory,
    more in place) and 40,000, their colours spanning five decades and
    signs: the sort path's bits."""
    from corona13_tpu_torch.ops import splat
    sizes = [1, 32, 33, 16384, 16385, 40000]
    g = torch.Generator().manual_seed(15)
    pix = torch.cat([torch.full((k,), 7 * i + 3) for i, k in enumerate(sizes)])
    n = pix.shape[0]
    col = 10.0 ** (torch.rand(n, 3, generator=g) * 5 - 2)
    col = col * torch.where(torch.rand(n, 3, generator=g) < 0.3, -1.0, 1.0)
    perm = torch.randperm(n, generator=g)
    pi = (pix % 64).float()[perm].to(cuda) + 0.5
    pj = (pix // 64).float()[perm].to(cuda) + 0.5
    col = col[perm].to(cuda)
    fb0 = torch.zeros((8, 64, 3), device=cuda)
    (t,) = splat._taps(8, 64, pi, pj, col, 'box')
    got = splat._scatter(fb0, *t).view(torch.int32)
    want = splat._scatter_sorted(fb0, *t).view(torch.int32)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize('kind', ['blackmanharris', 'spline', 'gaussian'])
def test_fused_footprint_against_sort_path(cuda, kind, capsys):
    """``splat`` with a 4x4 filter on the card (the footprint formed in the
    kernel) against the sort path over the plain footprint on the same
    card tensors, on finite splats (the card's plain path sends a splat
    with a NaN coordinate to pixel 0, the kernel drops it as the CPU's
    does): bit-equal (the kernel repeats torch's operations on the card,
    its division by a Python scalar as a product with the reciprocal and
    its 16-tap sum's tree; the pixels that differ are printed), and the
    same taps summed.  Splats with coordinates that are not finite add
    nothing; the same bits under a permutation and on a second run."""
    from corona13_tpu_torch import tracing
    from corona13_tpu_torch.ops import splat
    n, w, h = 1 << 18, 256, 144
    pi, pj, col = [x.to(cuda) for x in _splat_inputs(n, w, h, 11, odd=False)]
    fb0 = torch.zeros((h, w, 3), device=cuda)
    with tracing.counting() as counters:
        got = splat.splat(fb0, pi, pj, col, kind)
        want = fb0
        for t in splat._taps(h, w, pi, pj, col, kind):
            want = splat._scatter_sorted(want, *t)
        (k_sum, k_all), (s_sum, s_all) = counters.splat_taps()
    assert (k_sum, k_all) == (s_sum, s_all) and 0 < k_sum < k_all
    diff = (got - want).abs().amax(dim=-1)
    err = float(diff.max() / want.abs().max())
    with capsys.disabled():
        print(f'\n{kind}: fused footprint against the sort path: '
              f'{int((diff > 0).sum())} of {h * w} pixels differ, the largest '
              f'by {err:.3e} of the largest pixel, at '
              f'{(diff > 0).nonzero().tolist()[:8]}')
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), err
    odd = torch.tensor([float('nan'), 3.0, float('inf'), -float('inf')],
                       device=cuda)
    more = splat.splat(fb0, torch.cat([pi, odd]), torch.cat([pj, odd.flip(0)]),
                       torch.cat([col, torch.ones(4, 3, device=cuda)]), kind)
    assert torch.equal(more.view(torch.int32), got.view(torch.int32))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(12))
    perm = perm.to(cuda)
    again = splat.splat(fb0, pi[perm], pj[perm], col[perm], kind)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize('kind', ['blackmanharris', 'bilin', 'dbor'])
def test_splat_gradient_on_the_card(cuda, kind):
    """d sum(fb * g) / d col through the kernel's autograd Functions
    against autograd through the sort path on the same card tensors,
    within 1e-6 of its largest value; a pix_i that requires grad raises."""
    from corona13_tpu_torch.ops import splat
    n, w, h = 1 << 16, 128, 72
    pi, pj, col = [x.to(cuda) for x in _splat_inputs(n, w, h, 13, odd=False)]
    shape = (splat.N_DBOR, h, w, 3) if kind == 'dbor' else (h, w, 3)
    gout = torch.rand(shape, generator=torch.Generator().manual_seed(14))
    gout = gout.to(cuda)

    def grad(sorted_path):
        c = col.clone().requires_grad_()
        fb = torch.zeros(shape, device=cuda)
        if kind == 'dbor':
            taps = splat._dbor_taps(h, w, pi, pj, c)
        elif sorted_path:
            taps = splat._taps(h, w, pi, pj, c, kind)
        else:
            fb = splat.splat(fb, pi, pj, c, kind)
            taps = []
        for t in taps:
            fb = (splat._scatter_sorted if sorted_path
                  else splat._scatter)(fb, *t)
        (fb * gout).sum().backward()
        return c.grad
    want = grad(True)
    err = float((grad(False) - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err
    with pytest.raises(NotImplementedError):
        splat.splat(torch.zeros(h, w, 3, device=cuda),
                    pi.clone().requires_grad_(), pj, col)


@pytest.mark.parametrize('kind', _SPLAT_KINDS)
def test_splat_chain_makes_no_synchronising_call(cuda, kind):
    """splat and splat_dbor on the card, counted or not, under torch's
    sync debug mode: any call through torch that waits for the card (a
    read back to the host, a synchronisation) raises."""
    from corona13_tpu_torch import tracing
    from corona13_tpu_torch.ops import splat
    n, w, h = 1 << 16, 128, 72
    pi, pj, col = [x.to(cuda) for x in _splat_inputs(n, w, h, 15)]
    shape = (splat.N_DBOR, h, w, 3) if kind == 'dbor' else (h, w, 3)
    fb = torch.zeros(shape, device=cuda)

    def run():
        if kind == 'dbor':
            return splat.splat_dbor(fb, pi, pj, col)
        return splat.splat(fb, pi, pj, col, kind)
    want = run()                     # builds the library outside the mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with tracing.counting() as counters:
            got = [run(), run()]
        with pytest.raises(RuntimeError):
            float(want.sum())                # the mode is on: a read raises
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bits = want.view(torch.int32)           # NaN colours: compare bits
    assert all(torch.equal(g.view(torch.int32), bits) for g in got)
    assert all(0 < s <= t for s, t in counters.splat_taps())


_BDPT_STRATEGIES = [(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (2, 2), (1, 1),
                    (2, 1)]


@pytest.mark.parametrize('st', _BDPT_STRATEGIES,
                         ids=lambda st: f's{st[0]}t{st[1]}')
def test_bdpt_strategy_on_the_card(cuda, st):
    """Each bdpt strategy of max_verts=4 on the card against the CPU at
    64x42 (a 3:2 film, so that the ceiling light is on it: at 64x36 the
    s = 0, t = 2 and s = 1, t = 1 images are black): each pixel within 1e-4
    of the largest on >= 99% of the pixels;
    both subpaths traced (3 eye and 1 light closest-hit calls) and one
    any-hit call for a connection (s >= 1)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import bdpt, pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=42, max_verts=4, mf=4)
    out = []
    for d in (cuda, torch.device('cpu')):
        sc = scene_mod.fit_film(testing.cornell_scene(device=d), 64, 42)
        before = dict(tracing.launches)
        out.append(bdpt.render_sample(sc, cfg, 3, only=st).cpu().numpy())
        if d is cuda:
            moved = _moved(before)
            calls = {'closest': 4, 'any': int(st[0] >= 1)}
            want = {f'{p}{k}': v for k, v in calls.items() if v
                    for p in ('', 'dense_sphere_')}
            if st[1] == 1:      # the camera connection's general splat
                want['splat_footprint'] = 1
            assert moved == want, moved
    top = float(np.abs(out[1]).max())
    assert top > 0
    close = np.isclose(out[0], out[1], rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize('name', ['ppm', 'kmlt', 'vmlt'])
def test_ppm_mlt_on_the_card(cuda, name):
    """ppm, kmlt and vmlt (chains=256, burn_in=8) on the card against the
    CPU on cornell at 64x36: each pixel within 1e-4 of the largest on
    >= 99% of the pixels; for the chains, where an accept flips on an
    ulp, >= 99% of the chains in the same final state (rejection count
    equal, primary samples within 1e-6) and the frame means within 1e-3
    instead.  ppm launches closest-hit only, the chains both."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import kmlt, ppm, vmlt
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=6, mf=4)
    out = []
    for d in (cuda, torch.device('cpu')):
        sc = scene_mod.fit_film(testing.cornell_scene(device=d), 64, 36)
        before = dict(tracing.launches)
        if name == 'ppm':
            out.append({'image': ppm.render_sample(sc, cfg, 3)})
        else:
            mod = {'kmlt': kmlt, 'vmlt': vmlt}[name]
            out.append(kmlt.run_chains(sc, cfg, 3, 1, 256, 8,
                                       mod.STUCK_LIMIT, mod.MULT, mod.step))
        moved = {k for k, v in tracing.launches.items() if v != before[k]}
        if d is cuda:
            assert 'closest' in moved
            assert ('any' in moved) == (name != 'ppm'), moved
    card, cpu = ({k: v.cpu() for k, v in o.items() if torch.is_tensor(v)}
                 for o in out)
    top = float(cpu['image'].abs().max())
    assert top > 0 and torch.isfinite(card['image']).all()
    close = torch.isclose(card['image'], cpu['image'], rtol=0,
                          atol=1e-4 * top).all(dim=-1).float().mean()
    if name != 'ppm' and close < 0.99:
        same = ((card['rejects'] == cpu['rejects'])
                & torch.isclose(card['u'], cpu['u'], rtol=0, atol=1e-6)
                .all(dim=-1)).float().mean()
        mean_rel = abs(float(card['image'].mean() / cpu['image'].mean()) - 1)
        assert same >= 0.99 and mean_rel <= 1e-3, (close, same, mean_rel)
    else:
        assert close >= 0.99, close


def test_sharded_render_on_the_card(cuda):
    """parallel.shard on the card: meshes (2, 2) and (1, 4) emulated rank
    after rank equal the sum of pt.render_sample over the mesh's samples
    at the JAX test's tolerance (rtol 2e-4, atol 1e-5) off the 7x7 reach
    of the samples whose pixel-aligned splat lands one pixel short (see
    test_pixel_aligned_splat_moves_carried_samples_reference_defect), and
    the shard function's own frames of the whole film everywhere (a check
    of the split); each shard launches the traversal kernels, and
    train_step_theta's gradients on the card equal the CPU's (1e-3 of the
    largest for the linear parameters, 5e-3 for focus)."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.parallel import shard
    from corona13_tpu_torch.samplers import pt as pt_mod
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=6, mf=4)
    scenes = [scene_mod.fit_film(testing.cornell_scene(device=d), 64, 36)
              for d in (cuda, torch.device('cpu'))]
    sc = scenes[0]
    dev = sc.device
    pix = torch.arange(64 * 36, device=dev)
    with torch.no_grad():
        whole = [shard.render_shard(sc, cfg, shard.make_mesh(), s, 0)
                 for s in (0, 1)]
        single = [pt_mod.render_sample(sc, cfg, s) for s in (0, 1)]
        near = []
        for s in (0, 1):
            _, _, pi, pj = pt_mod.sample_paths(sc, cfg, s, pix)
            c = (torch.floor(pi) != pix % 64) | (torch.floor(pj) != pix // 64)
            near.append(torch.nn.functional.max_pool2d(
                c.reshape(1, 1, 36, 64).float(), 7, stride=1,
                padding=3)[0, 0] > 0)
        for n_sp, n_px in ((2, 2), (1, 4)):
            mesh = shard.make_mesh(n_sp, n_px)
            before = tracing.launches['closest']
            fb = shard.render_samples_sharded(sc, cfg, mesh, 0, emulate=True,
                                              device=dev)
            assert tracing.launches['closest'] == before + 5 * mesh.size
            off = ~torch.stack(near[:n_sp]).any(0)
            assert float(off.float().mean()) > 0.5
            torch.testing.assert_close(fb[off], sum(single[:n_sp])[off],
                                       rtol=2e-4, atol=1e-5)
            torch.testing.assert_close(fb, sum(whole[:n_sp]), rtol=2e-4,
                                       atol=1e-5)
    target = (whole[0] * 0.8).cpu()
    theta = {'d_mul': torch.ones(sc.materials.d_mul.shape[0]),
             'e_mul': torch.tensor(1.0), 'med_sigma': torch.tensor(1.0),
             'focus': torch.tensor(1.0)}
    grads = [shard.train_step_theta(s, cfg, shard.make_mesh(1, 2), target,
                                    theta, emulate=True, device=s.device)[1]
             for s in scenes]
    for k, tol in (('d_mul', 1e-3), ('e_mul', 1e-3), ('focus', 5e-3)):
        card, cpu = grads[0][k].cpu(), grads[1][k]
        assert torch.isfinite(card).all() and float(cpu.abs().max()) > 0, k
        assert float((card - cpu).abs().max()) <= tol * float(
            cpu.abs().max()), (k, card, cpu)


# --- the counter RNG's kernel (ops/rng_cuda.py) against its torch path -----

_RNG_EDGE = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1 << 32, -1, -2,
             -(1 << 31), (1 << 62) + 3]


def _rng_ids(n, seed, dev):
    """[n] int64 ids: random words over the whole int64 range, every other
    one cut to 32 bits (the ids a wavefront holds), the edge words first
    and last."""
    g = np.random.default_rng(seed)
    x = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    x[1::2] &= 0xFFFFFFFF
    k = min(len(_RNG_EDGE), n)
    x[:k] = _RNG_EDGE[:k]
    x[n - k:] = _RNG_EDGE[::-1][:k]
    return torch.as_tensor(x).to(dev)


@pytest.mark.parametrize('n', [2073600, 589824, 1, 257])
def test_rng_kernel_bits_equal_the_torch_path(cuda, n):
    """rng.uniform through the kernel against uniform_plain on the same
    card, at both cells' widths: the sample as ids a lane, as Python ints
    (negative, >= 2^32), as a 0-dim tensor and as one expanded to the
    lanes (stride 0); dims and seeds at their edges (bdpt's light stream
    seeds cfg.seed + 0x9e37, past 2^32).  Every float bit-equal, one
    launch a draw; the CPU's torch path gives the same bits."""
    from corona13_tpu_torch.ops import rng
    pix, smp = _rng_ids(n, 1, cuda), _rng_ids(n, 2, cuda)
    one = torch.tensor(7, dtype=torch.int64, device=cuda)
    samples = [smp, 12345, -1, (1 << 32) + 9, one, one.expand(n)]
    words = [(0, 0), (int(rng.Dim.NEE_X) + 101 * 3, 0xFFFFFFFF),
             (0x7fffffff, 0xFFFFFFFF + 0x9e37), (-3, -1)]
    before = tracing.launches['rng_uniform']
    for sample in samples:
        for dim, seed in words:
            got = rng.uniform(pix, sample, dim, seed)
            want = rng.uniform_plain(pix, sample, dim, seed)
            assert got.shape == (n,) and got.dtype == torch.float32
            assert torch.equal(_bits(got), _bits(want)), (sample, dim, seed)
    torch.cuda.synchronize()
    assert tracing.launches['rng_uniform'] == before + len(samples) * len(
        words)
    cpu = rng.uniform_plain(pix.cpu(), smp.cpu(), 5, 0x1234)
    assert torch.equal(_bits(rng.uniform(pix, smp, 5, 0x1234).cpu()),
                       _bits(cpu))


def test_rng_kernel_makes_no_synchronising_call(cuda):
    """A draw through the kernel, under torch's sync debug mode: nothing
    waits for the card."""
    from corona13_tpu_torch.ops import rng
    pix = torch.arange(1 << 16, device=cuda)
    one = torch.tensor(3, device=cuda)
    want = rng.uniform(pix, pix, 1, 2)      # builds outside the mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = [rng.uniform(pix, s, 1, 2) for s in (pix, 3, one)]
        with pytest.raises(RuntimeError):
            float(want.sum())                # the mode is on: a read raises
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], got[2])


def test_rng_kernel_takes_every_form(cuda):
    """The forms that are not the wavefront's (kmlt's [C, 1] x [1, D]
    broadcasts, tensor dims and seeds, int32 ids, strided views, a 0-dim
    pixel, numpy words) go through the kernel too, one launch a draw, with
    the torch path's bits and shape."""
    from corona13_tpu_torch.ops import rng
    pix = _rng_ids(4096, 3, cuda)
    cid = torch.arange(512, dtype=torch.int64, device=cuda)
    dims = torch.arange(200, 264, device=cuda)
    forms = [(cid[:, None], torch.tensor(11, device=cuda), dims[None, :], 3),
             (cid[:, None], 17, dims[None, :], 3),
             (pix, pix, 5, torch.full((4096,), -3, device=cuda)),
             (pix.int(), pix.int().flip(0), 5, 1), (pix[::2], pix[1::2], 5, 1),
             (torch.tensor(-7, device=cuda), pix, 5, 1),
             (pix, np.int64(3), np.int32(5), np.uint32(0xFFFFFFFF)),
             (pix.reshape(16, 256), torch.arange(256, device=cuda), 1, 2)]
    before = tracing.launches['rng_uniform']
    for args in forms:
        got, want = rng.uniform(*args), rng.uniform_plain(*args)
        assert got.shape == want.shape and got.is_cuda
        assert torch.equal(_bits(got), _bits(want))
    torch.cuda.synchronize()
    assert tracing.launches['rng_uniform'] == before + len(forms)


def _draw_counters(monkeypatch):
    """Count rng.uniform's draws and those the torch path made on a card's
    tensor."""
    from corona13_tpu_torch.ops import rng
    draws, on_card = [], []
    uniform, plain = rng.uniform, rng.uniform_plain

    def counted(*a):
        draws.append(a)
        return uniform(*a)

    def counted_plain(*a):
        on_card.append(torch.as_tensor(a[0]).is_cuda)
        return plain(*a)
    monkeypatch.setattr(rng, 'uniform', counted)
    monkeypatch.setattr(rng, 'uniform_plain', counted_plain)
    return draws, on_card


def _refuse_rng_kernel(monkeypatch):
    """Every draw on the card through the torch path in place of the
    kernel."""
    from corona13_tpu_torch.ops import rng, rng_cuda
    monkeypatch.setattr(rng_cuda, 'uniform',
                        lambda *a: rng.uniform_plain(*a))


@pytest.mark.parametrize('cell', ['0002_mb', '0031_hete', '0002_mb_bdpt'])
def test_rng_kernel_in_a_progression(cuda, monkeypatch, cell):
    """A 64x36 progression at each cell's settings with the kernel and
    with it refused: the image's bits equal; with it, one 'rng_uniform'
    launch a draw, 41 / 62 / 43 draws, and no draw on a card's tensor on
    the torch path."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import bdpt, pt as pt_mod
    cs = _smoke()
    media = cell == '0031_hete'
    sc, _ = scene_mod.load_scene(cs._scene_path(cell.split('_bdpt')[0]),
                                 device=cuda)
    sc = scene_mod.fit_film(sc, 64, 36)
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=8 if media else 6,
                          mf=4, use_nee=True, media=media)
    frame = bdpt.render_sample if cell.endswith('bdpt') else \
        pt_mod.render_sample
    draws, on_card = _draw_counters(monkeypatch)
    before = tracing.launches['rng_uniform']
    with torch.no_grad():
        img = frame(sc, cfg, 3)
    torch.cuda.synchronize()
    n = {'0002_mb': 41, '0031_hete': 62, '0002_mb_bdpt': 43}[cell]
    assert len(draws) == n
    assert tracing.launches['rng_uniform'] - before == n
    assert not any(on_card)
    _refuse_rng_kernel(monkeypatch)
    with torch.no_grad():
        ref = frame(sc, cfg, 3)
    assert on_card == [True] * n
    assert tracing.launches['rng_uniform'] - before == n
    assert float(img.sum()) > 0
    assert torch.equal(_bits(img), _bits(ref))


@pytest.mark.parametrize('sampler', ['kmlt', 'vmlt'])
def test_rng_kernel_in_mlt_chains(cuda, monkeypatch, sampler):
    """kmlt's and vmlt's chains on cornell (2-D draws of [C, D], scalar
    draws a chain) with the kernel and with it refused: the image and the
    chains' states bit-equal; every draw one 'rng_uniform' launch, none
    on the torch path."""
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import kmlt, vmlt
    from corona13_tpu_torch.samplers import pt as pt_mod
    mod = {'kmlt': kmlt, 'vmlt': vmlt}[sampler]
    sc = scene_mod.fit_film(testing.cornell_scene(device=cuda), 64, 36)
    cfg = pt_mod.PTConfig(width=64, height=36, max_verts=6, mf=4,
                          use_nee=True)
    draws, on_card = _draw_counters(monkeypatch)
    runs = []
    for turn in ('kernel', 'refused'):
        if turn == 'refused':
            _refuse_rng_kernel(monkeypatch)
        before = tracing.launches['rng_uniform']
        with torch.no_grad():
            runs.append(kmlt.run_chains(sc, cfg, 5, 1, 256, 8,
                                        mod.STUCK_LIMIT, mod.MULT, mod.step))
        torch.cuda.synchronize()
        if turn == 'kernel':
            n = len(draws)
            assert n > 0 and not any(on_card)
            assert tracing.launches['rng_uniform'] - before == n
    assert on_card == [True] * n
    got, ref = runs
    assert float(got['image'].sum()) > 0
    for k in ('image', 'u'):
        assert torch.equal(_bits(got[k]), _bits(ref[k])), k
    assert torch.equal(got['rejects'], ref['rejects'])
