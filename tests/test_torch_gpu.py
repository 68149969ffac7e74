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


@pytest.mark.parametrize('n_tris,n_rays', [(700, 300), (20000, 65536)])
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_matches_plain(cuda, n_tris, n_rays, any_hit):
    """Kernel and plain version on the same card and inputs: prim and slot
    identical on >= 99.9% of rays (both round the same expressions;
    -fmad=false), t within rtol 1e-6 where prim agrees."""
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
    before = dict(trace_cuda.launches)
    k = trace_cuda.traverse_tris(b.wbounds, b.wlinks, b.leaf_packed, org, d,
                                 t0, ig, ig2, any_hit=any_hit)
    torch.cuda.synchronize()
    key = 'any' if any_hit else 'closest'
    assert trace_cuda.launches[key] == before[key] + 1
    p = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                       org, d, t0, ig, ig2, any_hit=any_hit)
    k = [x.cpu().numpy() for x in k]
    p = [x.cpu().numpy() for x in p]
    assert (k[1] == p[1]).mean() >= 0.999
    assert (k[4] == p[4]).mean() >= 0.999
    assert (k[1][:17] == -1).all() and (k[0][:17] == 0.0).all()
    agree = (k[1] == p[1]) & (k[1] >= 0)
    if not any_hit:
        assert agree.mean() > 0.1
        np.testing.assert_allclose(k[0][agree], p[0][agree], rtol=1e-6)
        np.testing.assert_allclose(k[2][agree], p[2][agree], atol=1e-6)
        np.testing.assert_allclose(k[3][agree], p[3][agree], atol=1e-6)


def test_kernel_rejects_bad_inputs(cuda):
    geom = ttrace.make_device_geometry(tri_v=_soup(50, 1), device=cuda)
    b = geom.tri_bvh
    org, d = _rays(64, 2, cuda)
    t0 = torch.full((64,), 1e30, device=cuda)
    ig = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        trace_cuda.traverse_tris(b.wbounds, b.wlinks, b.leaf_packed, org, d,
                                 t0, ig.long())
    with pytest.raises(ValueError):
        trace_cuda.traverse_tris(b.wbounds, b.wlinks, b.leaf_packed,
                                 org.t().contiguous().t(), d, t0, ig)
    with pytest.raises(ValueError):
        trace_cuda.traverse_tris(b.wbounds, b.wlinks, b.leaf_packed,
                                 org.cpu(), d, t0, ig)
