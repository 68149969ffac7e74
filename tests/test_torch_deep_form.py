"""The deep form: a tree too deep for the wide walk's stack, on the CPU.

A binned-SAH tree over a scene that spans many orders of magnitude in
scale (``chip_smoke.zoom_ribbon``: a log-spiral ribbon whose triangles
shrink towards its centre) peels off a few large triangles at every level,
so its wide depth exceeds what the wide walk's stack holds (wdepth*7 + 8 >
192) and neither package gives it a wide layout.  The JAX package walks it
with XLA's skip-link ``_traverse``; the port's CUDA deep walk reads its own
records (``trace_cuda.pack_bin_nodes``: both children of a binary node in
one 64 B record) and, for a tree deeper than ``MAX_BIN_STACK`` levels,
the skip links themselves.  These tests hold, on the CPU:

- (a) the port's ``intersect`` / ``occluded`` on such a tree, with no limit
  patched, against the JAX package's: prim and the blocked flag equal on
  >= 99.9% of rays, t within rtol 1e-6 where prim agrees (XLA contracts
  multiply-adds the port rounds twice; the walk and the winner are the
  same);
- (b) the deep walk's records to the tree's arrays (``FlatBVH``), bit for
  bit, and each leaf's filled rows;
- (c) the deep walk, emulated in lockstep torch (``scripts/deep_order.py``
  on the records of (b)), to the plain skip-link walk bit for bit, on
  camera rays and on rays aimed at edges two leaves share, closest-hit and
  any-hit;
- (d) the choice at upload: a tree over the deep stack limit takes the
  skip form, and answers as the deep form does.

The card-side counterparts (the kernels against the plain walk, bit for
bit, at the zoom frame's shapes and on its edge rays) are in
tests/test_torch_gpu.py.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corona13_tpu.ops import trace as jtrace
from corona13_tpu_torch.ops import bvh as tbvh
from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
MAX_DIST = 3.4e38
N = 4096
# a ribbon of 4,096 triangles shrinking 0.985 a sample: wdepth 27, a wide
# stack need of 197 > 192
RIBBON = dict(n_tris=4096, shrink=0.985)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def smoke():
    return _module('chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))


@pytest.fixture(scope='module')
def walks():
    return _module('deep_order', os.path.join(ROOT, 'scripts',
                                              'deep_order.py'))


@pytest.fixture(scope='module')
def ribbon(smoke):
    """(triangles, the port's geometry on the CPU) of the small ribbon."""
    tri = smoke.zoom_ribbon(**RIBBON)
    return tri, ttrace.make_device_geometry(tri_v=tri, device='cpu')


def _camera_rays(n, seed, tri=None):
    """Rays from the zoom frame's eye (0, 0, 3): a quarter at points of the
    ribbon's disk, and from points beside the ribbon in random directions,
    a quarter; with ``tri``, half at points inside (barycentrics at least
    0.1 from every edge) of random triangles more than 1e-5 across, which
    lie deep in the tree."""
    g = np.random.default_rng(seed)
    k = n // 4
    aim = np.concatenate([g.uniform(-1.3, 1.3, (k, 2)), np.zeros((k, 1))],
                         axis=1)
    if tri is not None:
        big = np.nonzero(np.linalg.norm(tri[:, 1] - tri[:, 0], axis=1)
                         > 1e-5)[0]
        pick = tri[g.choice(big, n // 2)].astype(np.float64)
        b = g.uniform(0.1, 0.8, (n // 2, 2))
        b[:, 1] = np.minimum(b[:, 1], 0.9 - b[:, 0])
        aim = np.concatenate([aim, pick[:, 0] + b[:, 0:1] * (
            pick[:, 1] - pick[:, 0]) + b[:, 1:2] * (pick[:, 2] - pick[:, 0])])
    eye = np.array([0.0, 0.0, 3.0])
    m = n - len(aim)
    org = np.concatenate([np.tile(eye, (len(aim), 1)),
                          g.uniform(-1.0, 1.0, (m, 3)) * [1.3, 1.3, 0.1]])
    d = np.concatenate([aim - eye, g.normal(size=(m, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _ray_args(org, d, first):
    """Ignore ids from a first pass on a third of the lanes, bounded t_max
    and shadow segments, some dead lanes."""
    n = len(org)
    lane = np.arange(n)
    ig = np.where(lane % 3 == 1, first, -1).astype(np.int32)
    t_max = np.where(lane % 5 == 0, 2.0, MAX_DIST).astype(np.float32)
    t_max[:16] = 0.0
    seg = np.where(lane % 2 == 0, 1.5, 4.0).astype(np.float32)
    seg[:16] = 0.0
    return ig, t_max, seg


def test_ribbon_is_deep(ribbon):
    """Neither package gives the ribbon's tree a wide layout: wdepth >= 27,
    its wide stack need above 192; the port lays it out for the deep walk,
    its binary levels within MAX_BIN_STACK."""
    tri, geom = ribbon
    flat = tbvh.build_bvh(*tbvh.tri_bounds(tri))
    wdepth = tbvh.collapse8(flat)[2]
    assert wdepth >= 27 and wdepth * 7 + 8 > trace_cuda.MAX_STACK
    b = geom.tri_bvh
    assert b.wbounds is None and b.knodes is None and b.bnodes is not None
    assert trace_cuda._form_of(b, 'tri') == 'deep'
    assert b.bin_depth == trace_cuda.bin_depth(b.nodes.numpy())
    assert 20 < b.bin_depth <= trace_cuda.MAX_BIN_STACK == 192
    assert jtrace.make_device_geometry(tri_v=tri).tri_bvh.wbounds is None


_CHILD = r'''
import json, sys
import numpy as np
import jax
jax.config.update('jax_default_device', jax.devices('cpu')[0])
import jax.numpy as jnp
from corona13_tpu.ops import trace as jtrace
spec = json.loads(sys.argv[1])
a = np.load(spec['inputs'])
geom = jtrace.make_device_geometry(tri_v=a['tri_v'])
assert geom.tri_bvh.wbounds is None     # XLA's skip-link _traverse
J = jnp.asarray
h = jtrace.intersect(geom, J(a['org']), J(a['d']), ignore_prim=J(a['ig']),
                     t_max=J(a['t_max']))
b = jtrace.occluded(geom, J(a['org']), J(a['d']), J(a['seg']),
                    ignore_prim=J(a['ig']), ignore_prim2=J(a['ig2']))
np.savez(spec['outputs'], t=h.t, prim=h.prim, u=h.u, v=h.v, slot=h.slot,
         blocked=b)
'''


def test_deep_tree_matches_jax(smoke, ribbon, tmp_path):
    """(a) intersect / occluded on the naturally deep tree, no limit
    patched, against the JAX package's (XLA's skip-link _traverse), every
    bit of (t, prim, u, v, slot) and the blocked flag on every ray: rays
    from the zoom frame's eye, half of them at the inside of triangles deep
    in the tree, and rays aimed at edges two leaves share, with ignore ids,
    bounded t_max and shadow segments.  JAX runs in a child process with
    XLA's multiply-add contraction off (the port rounds each operation
    once, as the CUDA kernels do): with it on, t differs by up to 1.6e-6
    relative on a few rays at the ribbon's tiny triangles, and rays aimed
    at the edges of its innermost triangles, far below float32's
    resolution at the ray's origin, flip between hit and miss."""
    tri, geom = ribbon
    cam = _camera_rays(N, 7, tri)
    e_org, e_d, _, _ = smoke.edge_rays(geom, N, 21, torch.device('cpu'))
    org = np.concatenate([cam[0], e_org.numpy()])
    d = np.concatenate([cam[1], e_d.numpy()])
    first = ttrace.intersect(geom, T(org), T(d)).prim.numpy()
    assert (first >= 0).mean() > 0.4
    ig, t_max, seg = _ray_args(org, d, first)
    ig2 = np.where(np.arange(len(org)) % 3 == 2, first, -1).astype(np.int32)
    h = ttrace.intersect(geom, T(org), T(d), ignore_prim=T(ig),
                         t_max=T(t_max))
    blocked = ttrace.occluded(geom, T(org), T(d), T(seg), ignore_prim=T(ig),
                              ignore_prim2=T(ig2))
    inputs, outputs = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(inputs, tri_v=tri, org=org, d=d, ig=ig, ig2=ig2, t_max=t_max,
             seg=seg)
    env = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS=(
        os.environ.get('XLA_FLAGS', '') + ' --xla_cpu_max_isa=AVX').strip())
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(
            os.pathsep) if p])
    subprocess.run([sys.executable, '-c', _CHILD, json.dumps(dict(
        inputs=str(inputs), outputs=str(outputs)))], env=env, check=True,
        timeout=300, cwd=ROOT)
    ref = dict(np.load(outputs))
    hit = ref['prim'] >= 0
    assert hit.mean() > 0.3 and ref['blocked'].mean() > 0.1
    bits = lambda x: np.ascontiguousarray(x).view(np.int32) \
        if x.dtype == np.float32 else x.astype(np.int64)
    port = dict(t=h.t, prim=h.prim, u=h.u, v=h.v, slot=h.slot,
                blocked=blocked)
    for k, x in port.items():
        a, b = bits(x.numpy()), bits(ref[k])
        if k in ('u', 'v'):
            # a miss keeps JAX's start value org.x * 0.0, a zero of either
            # sign
            np.testing.assert_array_equal(x.numpy()[~hit], 0.0)
            a, b = a[hit], b[hit]
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (port['prim'][:16] == -1).all() and not blocked[:16].any()


@pytest.mark.parametrize('tree', ['ribbon', 'plane', 'spheres'])
def test_deep_records_round_trip(smoke, ribbon, tree):
    """(b) pack_bin_nodes' records give back the tree's binary arrays bit
    for bit (node boxes, first slots, right children in preorder) and each
    leaf's filled rows; record 0 holds the root; no link is 0."""
    from corona13_tpu_torch import testing
    if tree == 'ribbon':
        tri = ribbon[0]
        flat = tbvh.build_bvh(*tbvh.tri_bounds(tri))
    elif tree == 'plane':
        geom = testing.plane_scene(device='cpu').geom
        flat = tbvh.flat_from_nodes(geom.tri_bvh.nodes.numpy(),
                                    geom.tri_bvh.leaf_prims.numpy())
    else:
        kw = smoke._sphere_soup(2000, 9)
        flat = tbvh.build_bvh(*tbvh.sphere_bounds(kw['sph_c'], kw['sph_r']))
    nodes = np.concatenate([
        flat.node_min, flat.node_max, flat.node_skip[:, None].view(np.float32),
        flat.node_first[:, None].view(np.float32)], axis=1)
    rec = trace_cuda.pack_bin_nodes(nodes, flat.leaf_prims)
    assert rec.shape == (int((flat.node_first < 0).sum()) + 1, 16)
    links = rec[:, 12:14].copy().view(np.int32)
    assert (links[1:] != 0).all() and links[0, 0] != 0
    lo, hi, first, right, fill = trace_cuda.unpack_bin_nodes(rec)
    bits = lambda a: np.ascontiguousarray(a, np.float32).view(np.int32)
    np.testing.assert_array_equal(bits(lo), bits(flat.node_min))
    np.testing.assert_array_equal(bits(hi), bits(flat.node_max))
    np.testing.assert_array_equal(first, flat.node_first)
    np.testing.assert_array_equal(right, flat.node_right)
    np.testing.assert_array_equal(fill, trace_cuda.leaf_fill(flat.leaf_prims))


@pytest.mark.parametrize('rays', ['camera', 'edges'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_deep_walk_is_the_skip_link_walk(smoke, walks, ribbon, rays,
                                         any_hit):
    """(c) the deep walk emulated on the ribbon's records equals the plain
    skip-link walk in every bit of (t, prim, u, v, slot), or of the blocked
    flag, on every ray; without the drop at the pop (a right child reached
    whatever the running t) it does not on the edge rays' closest hits."""
    tri, geom = ribbon
    b = geom.tri_bvh
    if rays == 'camera':
        org, d = (T(x) for x in _camera_rays(N, 8, tri))
        seg = T(np.full(N, 3.5, np.float32))
    else:
        org, d, _, seg = smoke.edge_rays(geom, N, 21, torch.device('cpu'))
    t = seg if any_hit else MAX_DIST
    bad, visits, _, steps, leafs, most = walks.compare(b, 'tri', org, d, t,
                                                       any_hit=any_hit)
    assert bad == 0
    assert int(leafs.sum()) > N // 4
    assert int(steps.sum()) < int(visits.sum())
    assert int(most.max()) <= b.bin_depth
    if rays == 'edges' and not any_hit:
        assert walks.compare(b, 'tri', org, d, t, order='nocull')[0] > 0


def test_over_the_stack_limit_takes_the_skip_form(monkeypatch, ribbon):
    """(d) a tree with more binary levels than MAX_BIN_STACK gets no deep
    records at upload and is walked by its skip links ('skip'); its answers
    on the CPU (the plain skip-link walk either way) equal the deep
    form's."""
    tri, geom = ribbon
    assert trace_cuda.MAX_BIN_STACK == 192
    org, d = (T(x) for x in _camera_rays(1024, 9, tri))
    want = ttrace.intersect(geom, org, d)
    assert bool((want.prim >= 0).any())
    monkeypatch.setattr(trace_cuda, 'MAX_BIN_STACK', geom.tri_bvh.bin_depth - 1)
    over = ttrace.make_device_geometry(tri_v=tri, device='cpu')
    assert over.tri_bvh.bnodes is None and over.tri_bvh.bin_depth == 0
    assert over.tri_bvh.knodes is None and over.tri_bvh.kleaves is not None
    assert trace_cuda._form_of(over.tri_bvh, 'tri') == 'skip'
    assert trace_cuda._count_key('skip', 'tri', True) == 'skip_any'
    stripped = ttrace.without_wide(geom.tri_bvh)
    assert stripped.bnodes is None
    got = ttrace.intersect(over, org, d)
    for k in ('t', 'prim', 'u', 'v', 'slot'):
        assert torch.equal(getattr(got, k), getattr(want, k))
    monkeypatch.undo()
    wide = ttrace.make_device_geometry(tri_v=tri[:500], device='cpu').tri_bvh
    assert wide.knodes is not None
    deep = ttrace.without_wide(wide)
    assert trace_cuda._form_of(deep, 'tri') == 'deep'
    assert deep.wbounds is None and deep.knodes is None
    np.testing.assert_array_equal(deep.bnodes.numpy().view(np.int32),
                                  trace_cuda.pack_bin_nodes(
                                      wide.nodes.numpy(),
                                      wide.leaf_prims.numpy()).view(np.int32))
