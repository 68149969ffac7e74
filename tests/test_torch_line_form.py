"""The line form's records: each fibre's own terms computed once, at upload.

The CUDA kernel's line records (``trace_cuda.pack_line_rows``) carry a
fibre's unit axis, length, slope k and k*k, which the cone test used to
compute for every ray.  These tests hold, on the CPU:

- the packed terms to the bits of the reference test's own expressions
  (``_cone_inline``: the cone test as ``trace_plain.ray_cone_intersect``
  wrote it inline before the terms were hoisted), on chip_smoke.py's hair
  fibres and its line-soup generator at 4,096 fibres;
- the cone test on packed records (``ray_cone_test``, what the plain walk
  and the kernel run) to ``_cone_inline`` and to ``ray_cone_intersect``,
  bit for bit;
- ``line_rows`` / ``unpack_line_rows`` to a bit-exact round trip, with the
  filled rows of a leaf first and counted;
- ``intersect`` / ``occluded`` on a 4,096-fibre hair geometry to the JAX
  package, at the tolerance ``tests/test_torch_prims.py::
  test_intersect_and_occluded_match_jax`` states for lines (t rtol 1e-4 /
  atol 1e-5 and u 1e-3 where prim agrees), held on a stated share of the
  rays: at the hair's shapes a ray that starts far from a fibre cancels in
  the cone quadratic's c = |o|^2 - ya^2 - s^2 (ROADMAP Queue 3), so an ulp
  between XLA's fused and torch's rounded arithmetic moves a few hits.
  Across the ray seeds 61-67 prim agreed on 0.9988-1.0000 of the rays and
  t on 0.9966-0.9994 of the agreeing ones, u on all; these are the bits
  the port computed before the terms were hoisted (the tests above).  The
  bars: prim and blocked >= 99.8%, t >= 99%, u on every ray.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu.ops import trace as jtrace
from corona13_tpu_torch import convert
from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_cuda, trace_plain
from corona13_tpu_torch.utils import math as tmath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, T = jnp.asarray, torch.as_tensor
N_FIBRES = 4096


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process (the suite runs in xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def smoke():
    """chip_smoke.py as a module: its hair scene and line soup generators."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fibres(smoke, which):
    """(line_vtx [L, 2, 3], line_radii [L, 2]) numpy, L = 4096."""
    if which == 'soup':
        soup = smoke._line_soup(N_FIBRES, 10)
        return soup['line_vtx'], soup['line_radii']
    g = smoke._hair_scene(torch.device('cpu'), n_fibers=N_FIBRES).geom
    vtx = torch.stack([g.line_v0, g.line_v1], dim=1).numpy()
    return vtx, torch.stack([g.line_r0, g.line_r1], dim=1).numpy()


def _cone_inline(v0, v1, r0, r1, org, direction):
    """The cone test with the fibre's terms computed inline, for every ray
    (``ray_cone_intersect`` before its terms were hoisted, line for line,
    with the port's correctly rounded root).
    Returns (t, y, ok) and the terms (unit axis, length, k)."""
    ax, ay, az = (v1 - v0).unbind(-1)
    length = tmath.sqrt(torch.clamp(ax * ax + ay * ay + az * az, min=1e-20))
    ax, ay, az = ax / length, ay / length, az / length
    ox, oy, oz = (org[..., None, :] - v0).unbind(-1)
    wx, wy, wz = direction[..., None, :].unbind(-1)
    ya = ox * ax + oy * ay + oz * az
    wd = wx * ax + wy * ay + wz * az
    k = (r1 - r0) / length
    ow = ox * wx + oy * wy + oz * wz
    oo = ox * ox + oy * oy + oz * oz
    s = r0 + k * ya
    a = 1.0 - wd * wd - k * k * wd * wd
    b = 2.0 * (ow - ya * wd - k * wd * s)
    c = oo - ya * ya - s * s
    disc = b * b - 4.0 * a * c
    sq = tmath.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    asafe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    t0 = q / asafe
    tiny = torch.abs(q) < 1e-20
    t1 = torch.where(tiny, 3.4e38, c / torch.where(tiny, 1.0, q))
    tlo, thi = torch.minimum(t0, t1), torch.maximum(t0, t1)

    def accept(t):
        y = ya + t * wd
        return (t > 0.0) & (y >= 0.0) & (y <= length)

    t = torch.where(accept(tlo), tlo, thi)
    ok = (disc > 0.0) & accept(t)
    y = torch.clamp((ya + t * wd) / length, 0.0, 1.0)
    return (t, y, ok), (torch.stack([ax, ay, az], dim=-1), length, k)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _slot_fields(geom):
    """The line BVH's records unpacked, and the fibre of each slot."""
    b = geom.line_bvh
    fields = trace_cuda.unpack_line_rows(b.kleaves)
    return fields, b.leaf_prims


def _rays(n, seed, vtx):
    """Rays from points around the fibres toward points among them."""
    g = np.random.default_rng(seed)
    lo, hi = vtx.reshape(-1, 3).min(0) - 1.0, vtx.reshape(-1, 3).max(0) + 1.0
    org = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    org[: n // 2] = np.float32(0.0)          # half from the camera's origin
    target = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d.astype(np.float32)


@pytest.mark.parametrize('which', ['hair', 'soup'])
def test_packed_line_terms_are_the_inline_bits(smoke, which):
    """Every filled slot's unit axis, length and k (and k*k) equal, bit for
    bit, what the reference test's expressions compute inline for that
    fibre, and v0 / r0 are the fibre's own."""
    vtx, radii = _fibres(smoke, which)
    geom = ttrace.make_device_geometry(line_vtx=vtx, line_radii=radii,
                                       device='cpu')
    (v0, ids, axis, r0, length, k, kk, _), prims = _slot_fields(geom)
    filled = prims >= 0
    assert torch.equal(ids.long(), prims) and int(filled.sum()) == N_FIBRES
    f = prims[filled]
    V0, V1 = T(vtx[:, 0])[f], T(vtx[:, 1])[f]
    R0, R1 = T(radii[:, 0])[f], T(radii[:, 1])[f]
    org = torch.zeros(1, 3)
    _, (axis_i, length_i, k_i) = _cone_inline(V0[None], V1[None], R0[None],
                                              R1[None], org, org + 1.0)
    assert _same_bits(v0[filled], V0) and _same_bits(r0[filled], R0)
    assert _same_bits(axis[filled], axis_i[0])
    assert _same_bits(length[filled], length_i[0])
    assert _same_bits(k[filled], k_i[0])
    assert _same_bits(kk[filled], k_i[0] * k_i[0])


@pytest.mark.parametrize('which', ['hair', 'soup'])
def test_packed_cone_test_is_ray_cone_intersect(smoke, which):
    """The cone test on the packed records (what the plain walk and the
    kernel run) gives the bits of the inline test and of
    ``ray_cone_intersect``, on every ray and fibre."""
    vtx, radii = _fibres(smoke, which)
    geom = ttrace.make_device_geometry(line_vtx=vtx, line_radii=radii,
                                       device='cpu')
    (v0, _, axis, r0, length, k, kk, _), prims = _slot_fields(geom)
    filled = prims >= 0
    f = prims[filled]
    org, d = (T(x) for x in _rays(48, 7, vtx))
    packed = trace_plain.ray_cone_test(
        v0[filled][None], axis[filled][None], length[filled][None],
        k[filled][None], kk[filled][None], r0[filled][None], org, d)
    args = (T(vtx[:, 0])[f][None], T(vtx[:, 1])[f][None],
            T(radii[:, 0])[f][None], T(radii[:, 1])[f][None], org, d)
    inline, _ = _cone_inline(*args)
    intersect = trace_plain.ray_cone_intersect(*args)
    assert bool(inline[2].any())
    for a, b, c in zip(packed, inline, intersect):
        assert _same_bits(a, b) and _same_bits(c, b)


def test_line_rows_round_trip(smoke):
    """unpack_line_rows then line_rows gives the records back bit for bit;
    each leaf's filled rows come first and every row of it carries their
    count."""
    vtx, radii = _fibres(smoke, 'hair')
    b = ttrace.make_device_geometry(line_vtx=vtx, line_radii=radii,
                                    device='cpu').line_bvh
    fields = trace_cuda.unpack_line_rows(b.kleaves)
    assert _same_bits(trace_cuda.line_rows(*fields), b.kleaves)
    ids, filled = fields[1].reshape(-1, 8), fields[7].reshape(-1, 8)
    n = (ids >= 0).sum(dim=1, dtype=torch.int32)
    assert torch.equal(filled, n[:, None].expand(-1, 8))
    assert bool((n >= 1).all())
    row = torch.arange(8)
    assert torch.equal(ids >= 0, row[None, :] < n[:, None])


def test_hair_intersect_and_occluded_match_jax(smoke):
    """intersect and occluded on chip_smoke.py's hair fibres (4,096, the
    line BVH) against the JAX package: ignore ids through either slot,
    dead lanes and bounded segments as in test_intersect_and_occluded_
    match_jax, at its line tolerances on the shares the module docstring
    states."""
    vtx, radii = _fibres(smoke, 'hair')
    jg = jtrace.make_device_geometry(line_vtx=vtx, line_radii=radii)
    tg = convert.scene_from_numpy(jg, device='cpu')
    n = 2500
    org, d = _rays(n, 61, vtx)
    t_max = np.full(n, 3.0e38, np.float32)
    t_max[::4] = 12.0
    t_max[:25] = 0.0
    first = np.asarray(jtrace.intersect(jg, J(org), J(d)).prim)
    lane = np.arange(n)
    ig = np.where(lane % 3 == 1, first, -1).astype(np.int32)
    ig2 = np.where(lane % 3 == 2, first, -1).astype(np.int32)
    jh = jtrace.intersect(jg, J(org), J(d), ignore_prim=J(ig), t_max=J(t_max))
    th = ttrace.intersect(tg, T(org), T(d), ignore_prim=T(ig).long(),
                          t_max=T(t_max))
    jp, tp = np.asarray(jh.prim), th.prim.numpy()
    assert (jp >= 0).mean() > 0.1 and (tp[:25] == -1).all()
    assert (tp == jp).mean() >= 0.998
    same = (tp == jp) & (jp >= 0)
    close = np.isclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                       rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(th.u.numpy()[same], np.asarray(jh.u)[same],
                               atol=1e-3)
    seg = np.where(lane % 2 == 0, 6.0, 14.0).astype(np.float32)
    seg[:25] = 0.0
    jb = np.asarray(jtrace.occluded(jg, J(org), J(d), J(seg),
                                    ignore_prim=J(ig), ignore_prim2=J(ig2)))
    tb = ttrace.occluded(tg, T(org), T(d), T(seg), ignore_prim=T(ig).long(),
                         ignore_prim2=T(ig2).long()).numpy()
    assert jb.mean() > 0.05 and not tb[:25].any()
    assert (tb == jb).mean() >= 0.998
