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
