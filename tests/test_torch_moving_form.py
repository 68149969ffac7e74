"""The moving form's records and walk order, and the dense line records.

The CUDA moving-triangle walk reads records packed at upload
(``trace_cuda.pack_moving_rows``): a row's shutter-open record carries the
index of its shutter-close record, or -1 where the row does not move, and
its leaf's filled rows; only the rows that move have a second record.  Its
closest-hit walk pops a node's children in the binary tree's preorder
(``trace_cuda.pack_nodes_preorder``) and drops an entry the running t
has passed.  A dense line list carries each line's
terms of the cone test, packed once (``trace_cuda.pack_dense_lines``).
These tests hold, on the CPU:

- the records to the reference's ``leaf_data`` / ``leaf_data_t1`` /
  ``leaf_prims`` by a bit-exact round trip, on the 0002_mb tree (12 of
  8,210 triangles move) and on a tree whose rows all move; the index set
  exactly where the two records differ in a bit; the filled count;
- a static row lerped from its one record to the two-record lerp, bit for
  bit, at times that include 0, 1 and values where 1 - w rounds;
- the preorder ranks to the skip-link walk's leaf order, and the wide walk
  in that order with the pop-time cull (``scripts/moving_order.py``, the
  kernel's walk emulated in torch) to the plain skip-link walk on every
  ray, on rays aimed at edges that two leaves of the 0002_mb plane share
  (where exact-t ties and hits an ulp before their box occur) and on
  random rays; the wide walk's index order is not (the reason for the
  order);
- ``trace.intersect`` / ``occluded`` with ray times on the 0002_mb scene
  and on the ``moving300`` geometry of tests/test_torch_prims.py, on a
  40-line dense list, to the JAX package on every ray, bit for bit (t,
  prim, u, v, slot; the blocked flag), on 300 spheres (the sphere form's
  BVH, its 16-byte records) too, since the port's root is correctly
  rounded as XLA's is (``utils.math.sqrt``).  XLA on this CPU contracts a
  multiply and an add into one fused operation where torch rounds twice,
  so the JAX side runs in a child process with ``--xla_cpu_max_isa=AVX``
  (no FMA): the reference's arithmetic rounded operation by operation, as
  torch and the kernel (built with ``-fmad=false``) round it;
- the dense line records to ``trace_plain.line_terms`` and the dense plain
  path on them to the cone test with the terms computed inline for every
  ray, bit for bit; its count of lines missed at the discriminant (the
  rows the kernel leaves early) to the discriminant's sign on live lanes.

The card-side counterparts (kernel against plain, bit-equal, both
instantiations, two launches identical) are in tests/test_torch_gpu.py.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu.ops import trace as jtrace
from corona13_tpu_torch import convert
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_cuda, trace_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = os.path.join(ROOT, 'data', 'golden', 'scenes', '0002_mb', 'test.nra2')
T = torch.as_tensor
MAX_DIST = 3.4e38


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process (the suite runs in xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def smoke():
    """chip_smoke.py as a module: its edge rays."""
    return _module('chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))


@pytest.fixture(scope='module')
def order():
    """scripts/moving_order.py as a module: the wide walk emulated."""
    return _module('moving_order', os.path.join(ROOT, 'scripts',
                                                'moving_order.py'))


@pytest.fixture(scope='module')
def mb():
    return tscene.load_scene(MB, device='cpu')[0]


def _moving300():
    """tests/test_torch_prims.py's 'moving300' geometry: every row moves."""
    g = np.random.default_rng(50)
    v0 = g.uniform(-10, 10, (300, 3)).astype(np.float32)
    e = g.uniform(-3.0, 3.0, (300, 2, 3)).astype(np.float32)
    tri = np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
    return dict(tri_v=tri, tri_v_t1=tri + g.uniform(
        -1.5, 1.5, (300, 1, 3)).astype(np.float32))


def _tree(which, mb):
    if which == '0002_mb':
        return mb.geom.tri_bvh
    return ttrace.make_device_geometry(**_moving300(), device='cpu').tri_bvh


def _bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


# --- the records -----------------------------------------------------------

@pytest.mark.parametrize('which', ['0002_mb', 'moving300'])
def test_moving_rows_round_trip(mb, which):
    """The records unpack to leaf_data, leaf_data_t1 and leaf_prims bit for
    bit, and are what pack_moving_rows gives for them."""
    b = _tree(which, mb)
    d0, d1, ids = trace_cuda.unpack_moving_rows(b.kleaves.numpy(),
                                                b.kleaves_t1.numpy())
    np.testing.assert_array_equal(_bits(d0), _bits(b.leaf_data))
    np.testing.assert_array_equal(_bits(d1), _bits(b.leaf_data_t1))
    np.testing.assert_array_equal(ids, b.leaf_prims.numpy())
    kl, kl1 = trace_cuda.pack_moving_rows(b.leaf_data.numpy(),
                                          b.leaf_data_t1.numpy(),
                                          b.leaf_prims.numpy())
    np.testing.assert_array_equal(_bits(kl), _bits(b.kleaves))
    np.testing.assert_array_equal(_bits(kl1), _bits(b.kleaves_t1))


@pytest.mark.parametrize('which', ['0002_mb', 'moving300'])
def test_second_record_exactly_where_a_row_moves(mb, which):
    """A slot's index is >= 0 exactly where its nine shutter-close floats
    differ from its shutter-open ones in a bit, and counts the moving
    slots in slot order; 0002_mb has 12 such slots, moving300 moves every
    filled slot."""
    b = _tree(which, mb)
    moved = b.kleaves.reshape(-1, 12)[:, 7].contiguous().view(torch.int32)
    moves = (_bits(b.leaf_data) != _bits(b.leaf_data_t1)).any(axis=1)
    np.testing.assert_array_equal(moved.numpy() >= 0, moves)
    np.testing.assert_array_equal(moved.numpy()[moves],
                                  np.arange(int(moves.sum())))
    assert b.kleaves_t1.shape == (int(moves.sum()), 12)
    filled = b.leaf_prims.numpy() >= 0
    if which == '0002_mb':
        assert int(moves.sum()) == 12 and int(filled.sum()) == 8210
    else:
        assert moves[filled].all()


@pytest.mark.parametrize('which', ['0002_mb', 'moving300'])
def test_filled_rows_count(mb, which):
    """Every row of a leaf carries (leaf_prims >= 0).sum() of its leaf,
    and those rows come first."""
    b = _tree(which, mb)
    ids = b.leaf_prims.reshape(-1, 8)
    n = (ids >= 0).sum(dim=1, dtype=torch.int32)
    words = b.kleaves.contiguous().view(torch.int32)
    assert torch.equal(words[:, :, 11], n[:, None].expand(-1, 8))
    assert torch.equal(ids >= 0, torch.arange(8)[None, :] < n[:, None])
    if which == '0002_mb':      # 78.0% of the slots filled
        assert int(n.sum()) == 8210 and ids.shape[0] == 1315


def test_static_row_lerp_is_the_two_record_lerp(mb):
    """A row without a second record, lerped with itself as the kernel
    writes it (a*(1-w) + b*w with b = a), equals the plain walk's lerp of
    its two equal records bit for bit, at w = 0, 1, random times and
    times where 1 - w rounds; and that lerp is not the identity, so the
    arithmetic stays."""
    b = mb.geom.tri_bvh
    rows = b.kleaves.reshape(-1, 12)
    static = rows[:, 7].contiguous().view(torch.int32) < 0
    q = torch.cat([rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]], dim=1)[static]
    g = np.random.default_rng(3)
    w = np.concatenate([[0.0, 1.0, 1e-8, 0.1, 0.3, 0.7, 1 - 2.0 ** -24,
                         2.0 ** -24], g.uniform(0, 1, 24)]).astype(np.float32)
    w = T(w)[:, None, None]
    assert bool(((1.0 - w).double() != 1.0 - w.double()).any())  # rounds
    one = q[None] * (1.0 - w) + q[None] * w
    two = trace_plain.lerp_rows(b.leaf_data[static][None],
                                b.leaf_data_t1[static][None], w)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    assert bool((one != q[None]).any())


# --- the walk order --------------------------------------------------------

def test_preorder_nodes_follow_the_skip_link_walk(mb):
    """Leaf ids are the skip-link walk's leaf order (the binary nodes in
    index order are its preorder); the moving form's nodes hold each
    node's children of pack_nodes in reverse preorder (preorder_ranks:
    by the least leaf id below a child), empty slots first, so that a
    node's leaf children pop in leaf id order."""
    b = mb.geom.tri_bvh
    first = b.nodes[:, 7].contiguous().view(torch.int32)
    leaves = first[first >= 0]
    assert torch.equal(leaves, torch.arange(len(leaves), dtype=torch.int32)
                       * 8)
    kn, pre = b.knodes.numpy(), b.knodes_pre.numpy()
    rank = trace_cuda.preorder_ranks(b.wbounds.numpy(), b.wlinks.numpy())
    for i in range(len(kn)):
        order = np.argsort(-rank[i], kind='stable')
        np.testing.assert_array_equal(_bits(pre[i]), _bits(kn[i][order]))
        w = pre[i, :, 6]
        assert (w[:int((w == 0).sum())] == 0).all()
        lids = pre[i, :, 7].copy().view(np.int32)[w >= 256]
        assert (np.diff(lids) < 0).all()    # popped last slot first


def _edge_or_random(smoke, mb, which, n=4096):
    if which == 'edges':
        org, d, tm, _ = smoke.edge_rays(mb.geom, n, 5, torch.device('cpu'))
        return org, d, tm
    g = np.random.default_rng(9)
    root = mb.geom.tri_bvh.nodes[0].numpy()
    org = g.uniform(root[0:3] - 2, root[3:6] + 2, (n, 3)).astype(np.float32)
    aim = g.uniform(root[0:3], root[3:6], (n, 3)).astype(np.float32)
    d = aim - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = g.uniform(0, 1, n).astype(np.float32)
    return T(org), T(d), T(tm)


@pytest.mark.parametrize('which', ['edges', 'random'])
def test_preorder_walk_is_the_skip_link_walk(smoke, order, mb, which):
    """The wide walk in preorder with the pop-time cull, as the kernel
    walks it, gives the plain skip-link walk's (t, prim, u, v, slot) on
    every ray; on the edge rays the index order does not."""
    b = mb.geom.tri_bvh
    org, d, tm = _edge_or_random(smoke, mb, which)
    n = org.shape[0]
    t = torch.full((n,), MAX_DIST)
    t[::5] = 15.0
    none = torch.full((n,), -1, dtype=torch.long)
    ref = trace_plain.walk_plain(b, 'moving', org, d, t, none, torch.zeros(n),
                                 torch.zeros(n), none, time=tm)
    assert float((ref[1] >= 0).float().mean()) > 0.3
    pre = order.wide_walk(b, org, d, tm, t, 'preorder')
    assert int(order.differing(pre, ref).sum()) == 0
    if which == 'edges':
        index = order.wide_walk(b, org, d, tm, t, 'index')
        assert int(order.differing(index, ref).sum()) > 0


# --- against the JAX package -------------------------------------------------

_CHILD = r'''
import json, sys
import numpy as np
import jax
jax.config.update('jax_default_device', jax.devices('cpu')[0])
import jax.numpy as jnp
from corona13_tpu import scene as jscene
from corona13_tpu.ops import trace as jtrace
spec = json.loads(sys.argv[1])
out = {}
for case in spec['cases']:
    a = np.load(spec['dir'] + f'/{case}_in.npz')
    if case == '0002_mb':
        geom = jscene.load_scene(spec['mb'])[0].geom
    elif case == 'moving300':
        geom = jtrace.make_device_geometry(tri_v=a['tri_v'],
                                           tri_v_t1=a['tri_v_t1'])
    elif case == 'spheres300':
        geom = jtrace.make_device_geometry(sph_c=a['sph_c'],
                                           sph_r=a['sph_r'])
    else:
        geom = jtrace.make_device_geometry(line_vtx=a['line_vtx'],
                                           line_radii=a['line_radii'])
    J = jnp.asarray
    h = jtrace.intersect(geom, J(a['org']), J(a['d']), ignore_prim=J(a['ig']),
                         t_max=J(a['t_max']), time=J(a['time']))
    b = jtrace.occluded(geom, J(a['org']), J(a['d']), J(a['seg']),
                        ignore_prim=J(a['ig']), ignore_prim2=J(a['ig2']),
                        time=J(a['time']))
    np.savez(spec['dir'] + f'/{case}_out.npz', t=h.t, prim=h.prim, u=h.u,
             v=h.v, slot=h.slot, blocked=b)
'''

JAX_CASES = ('0002_mb', 'moving300', 'lines40', 'spheres300')


def _spheres300():
    """300 spheres of the sphere frame's radii (chip_smoke._sphere_inputs)
    in a box, some overlapping: the sphere BVH's wide form."""
    g = np.random.default_rng(53)
    return dict(sph_c=g.uniform(-6, 6, (300, 3)).astype(np.float32),
                sph_r=g.uniform(0.05, 1.0, 300).astype(np.float32))


def _lines40():
    g = np.random.default_rng(50)
    a = g.uniform(-10, 10, (40, 3)).astype(np.float32)
    b = a + g.uniform(-3, 3, (40, 3)).astype(np.float32)
    return dict(line_vtx=np.stack([a, b], axis=1),
                line_radii=g.uniform(0.1, 0.6, (40, 2)).astype(np.float32))


@pytest.fixture(scope='module')
def against_jax(smoke, mb, tmp_path_factory):
    """Each case's rays and geometry, the port's intersect / occluded on
    them, and the JAX package's from a child process without FMA."""
    tmp = str(tmp_path_factory.mktemp('jax_ref'))
    port = {}
    for case in JAX_CASES:
        # the JAX package's own tree (its scene loader builds it natively),
        # carried over: both packages walk the same nodes
        if case == '0002_mb':
            extra = {}
            geom = convert.scene_from_numpy(jscene.load_scene(MB)[0],
                                            device='cpu').geom
            org, d, tm = (torch.cat(x) for x in zip(
                _edge_or_random(smoke, mb, 'edges', 2048),
                _edge_or_random(smoke, mb, 'random', 2048)))
        else:
            extra = {'moving300': _moving300, 'lines40': _lines40,
                     'spheres300': _spheres300}[case]()
            geom = convert.scene_from_numpy(
                jtrace.make_device_geometry(**extra), device='cpu')
            g = np.random.default_rng(51)
            o = g.uniform(-12, 12, (2500, 3)).astype(np.float32)
            dd = g.normal(size=(2500, 3)).astype(np.float32)
            if case == 'lines40':   # toward points near the lines
                vtx = extra['line_vtx'][g.integers(0, 40, 2500)]
                dd = vtx[:, 0] + g.uniform(0, 1, (2500, 1)) * (
                    vtx[:, 1] - vtx[:, 0]) + 0.3 * dd - o
            dd = (dd / np.linalg.norm(dd, axis=-1, keepdims=True)).astype(
                np.float32)
            org, d = T(o), T(dd)
            tm = T(np.random.default_rng(52).uniform(0, 1, 2500).astype(
                np.float32))
        n = org.shape[0]
        tm[::7], tm[1::7] = 0.0, 1.0
        t_max = torch.full((n,), 3.0e38)
        t_max[::4] = 10.0
        t_max[:25] = 0.0
        lane = torch.arange(n)
        first = ttrace.intersect(geom, org, d, time=tm).prim
        ig = torch.where(lane % 3 == 1, first, -1)
        ig2 = torch.where(lane % 3 == 2, first, -1)
        seg = torch.where(lane % 2 == 0, 6.0, 14.0)
        seg[:25] = 0.0
        h = ttrace.intersect(geom, org, d, ignore_prim=ig, t_max=t_max,
                             time=tm)
        blocked = ttrace.occluded(geom, org, d, seg, ignore_prim=ig,
                                  ignore_prim2=ig2, time=tm)
        port[case] = dict(t=h.t, prim=h.prim, u=h.u, v=h.v, slot=h.slot,
                          blocked=blocked)
        np.savez(os.path.join(tmp, f'{case}_in.npz'), org=org.numpy(),
                 d=d.numpy(), time=tm.numpy(), t_max=t_max.numpy(),
                 ig=ig.int().numpy(), ig2=ig2.int().numpy(),
                 seg=seg.numpy(), **extra)
    env = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS=(
        os.environ.get('XLA_FLAGS', '') + ' --xla_cpu_max_isa=AVX').strip())
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(
            os.pathsep) if p])
    spec = dict(cases=JAX_CASES, dir=tmp, mb=MB)
    subprocess.run([sys.executable, '-c', _CHILD, json.dumps(spec)],
                   env=env, check=True, timeout=300, cwd=ROOT)
    return {c: (port[c], dict(np.load(os.path.join(tmp, f'{c}_out.npz'))))
            for c in JAX_CASES}


@pytest.mark.parametrize('case', JAX_CASES)
def test_intersect_and_occluded_match_jax_bit_for_bit(against_jax, case):
    """Every ray's (t, prim, u, v, slot) and blocked flag equal the JAX
    package's in every bit: on 0002_mb among them the rays aimed at edges
    that two leaves share, where a tie or a hit an ulp before its box is
    decided by the reference's walk order."""
    port, ref = against_jax[case]
    hit = ref['prim'] >= 0
    assert hit.mean() > 0.02 and ref['blocked'].mean() > 0.02
    for k in ('t', 'prim', 'u', 'v', 'slot', 'blocked'):
        a, b = _bits(port[k]), _bits(ref[k])
        if k in ('u', 'v'):
            # where no hit sets it (a miss; v of a line hit; a sphere hit
            # sets neither) JAX keeps its start value org.x * 0.0, a zero of
            # either sign
            sets = hit & (case != 'lines40' or k == 'u') & \
                (case != 'spheres300')
            np.testing.assert_array_equal(port[k].numpy()[~sets], 0.0)
            np.testing.assert_array_equal(ref[k][~sets], 0.0)
            a, b = a[sets], b[sets]
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


# --- the dense line records -------------------------------------------------

def test_dense_line_records():
    """pack_dense_lines: each line's v0, r0 and terms (trace_plain.
    line_terms) with its index as id and the count last; the dense plain
    path on them gives the bits of the cone test with the terms computed
    inline for every ray (ray_cone_intersect)."""
    geo = _lines40()
    geom = ttrace.make_device_geometry(**geo, device='cpu')
    rec = geom.line_dense
    assert rec.shape == (40, 12)
    v0, v1 = T(geo['line_vtx'][:, 0]), T(geo['line_vtx'][:, 1])
    r0, r1 = T(geo['line_radii'][:, 0]), T(geo['line_radii'][:, 1])
    axis, length, k, kk = trace_plain.line_terms(v0, v1, r0, r1)
    ints = rec.contiguous().view(torch.int32)
    for got, want in ((rec[:, 0:3], v0), (rec[:, 4:7], axis), (rec[:, 7], r0),
                      (rec[:, 8], length), (rec[:, 9], k), (rec[:, 10], kk)):
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32))
    assert torch.equal(ints[:, 3], torch.arange(40, dtype=torch.int32))
    assert bool((ints[:, 11] == 40).all())
    g = np.random.default_rng(4)
    org = T(g.uniform(-12, 12, (512, 3)).astype(np.float32))
    d = T(g.normal(size=(512, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    n = org.shape[0]
    t = torch.full((n,), MAX_DIST)
    none = torch.full((n,), -1, dtype=torch.long)
    got = trace_plain.dense_plain('line', (rec,), org, d, t, none,
                                  torch.zeros(n), torch.zeros(n))
    tt, y, ok = trace_plain.ray_cone_intersect(v0[None], v1[None], r0[None],
                                               r1[None], org, d)
    want = trace_plain._closest_select(tt, ok, t, none, torch.zeros(n),
                                       torch.zeros(n),
                                       torch.arange(40).expand(n, -1), y)
    assert bool((want[1] >= 0).any())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize('any_hit', [False, True])
def test_dense_line_missed_rows(any_hit):
    """The plain dense line list with want_counts (what chip_smoke.py's
    exit bound reads): the hit is the one without counts, no node or leaf
    is counted, and the lines missed at the discriminant are, on each live
    lane, those whose discriminant from the prim's own terms (trace_plain.
    line_terms) is not positive; a dead lane counts none."""
    geo = _lines40()
    geom = ttrace.make_device_geometry(**geo, device='cpu')
    g = np.random.default_rng(5)
    n = 512
    org = T(g.uniform(-12, 12, (n, 3)).astype(np.float32))
    d = T(g.normal(size=(n, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    t0 = torch.where(T(g.uniform(size=n) < 0.8), MAX_DIST, 0.0).float()
    plain = trace_cuda.any_hit_plain if any_hit else \
        trace_cuda.closest_hit_plain
    hit, visits, leafs, missed = plain((geom.line_dense,), 'line', org, d, t0,
                                       want_counts=True)
    alone = plain((geom.line_dense,), 'line', org, d, t0)
    for a, b in zip((hit,) if any_hit else hit, (alone,) if any_hit else alone):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(visits.sum()) == 0 and int(leafs.sum()) == 0
    v0, v1 = T(geo['line_vtx'][:, 0]), T(geo['line_vtx'][:, 1])
    r0, r1 = T(geo['line_radii'][:, 0]), T(geo['line_radii'][:, 1])
    axis, _, k, kk = trace_plain.line_terms(v0, v1, r0, r1)
    disc = trace_plain._cone_disc(v0, axis, k, kk, r0, org, d)[5]
    want = torch.where(t0 > 0, (~(disc > 0.0)).sum(dim=-1), 0)
    assert torch.equal(missed, want)
    assert 0 < int(missed.sum()) < 40 * int((t0 > 0).sum())
