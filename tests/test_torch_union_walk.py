"""The port's union walk against the Pallas kernel with ``want_counters``.

The TPU kernel (``corona13_tpu/ops/trace_pallas.py:60-220``) walks, for
each 128-ray tile, the union of its rays' hits and counts the tile's inner
and leaf pops per 1024-ray block.  ``trace_cuda.union_walk_plain`` (what
``union_kernel`` computes on the card) and ``trace_cuda.traverse_tris(cpu
tensors, want_counters=True)``, which runs it, are held here to the Pallas
kernel in interpret mode on a 700-triangle soup, closest-hit and any-hit,
on tiles of every kind the counts depend on: one live lane a tile, full
tiles, a third of the lanes dead, a block without a live ray, tiles whose
rays are partly blocked, both ignore ids set, and a ragged N whose padded
tiles each pop the root once.

Tolerance: iters and leafs equal on every block; prim and slot identical
on every ray; t within rtol 1e-5 and u, v within atol 1e-5.  The Pallas
kernel runs in one child process without FMA (``--xla_cpu_max_isa=AVX``),
as tests/test_torch_edge_rays.py runs it: with multiply-adds fused, XLA
rounds a hit's t up to an ulp or two away from the kernel's expression,
which rounds each operation (``-fmad=false``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corona13_tpu.ops import trace as jtrace
from corona13_tpu_torch import convert
from corona13_tpu_torch.ops import trace_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAR = 3.0e38
CASES = ['one_live_lane', 'full_tiles', 'third_dead', 'dead_block',
         'partly_blocked', 'two_ignore_ids', 'ragged_1500']

# every case, closest-hit and any-hit, through the Pallas kernel in
# interpret mode: in.npz holds the tree and each case's rays, out.npz gets
# the seven outputs of each call
_CHILD = r'''
import json, sys
import numpy as np
import jax
jax.config.update('jax_default_device', jax.devices('cpu')[0])
import jax.numpy as jnp
from corona13_tpu.ops import trace_pallas
spec = json.loads(sys.argv[1])
a = np.load(spec['dir'] + '/in.npz')
out = {}
for name in spec['cases']:
    ig2 = a[name + '/ig2'] if name + '/ig2' in a else None
    for mode in ('closest', 'any'):
        res = trace_pallas.traverse_tris(
            jnp.asarray(a['wbounds']), jnp.asarray(a['wlinks']),
            jnp.asarray(a['leaf_packed']), jnp.asarray(a[name + '/org']),
            jnp.asarray(a[name + '/d']), jnp.asarray(a[name + '/t0']),
            jnp.asarray(a[name + '/ig']),
            None if ig2 is None else jnp.asarray(ig2),
            any_hit=mode == 'any', interpret=True, want_counters=True)
        for i, x in enumerate(res):
            out[f'{name}/{mode}/{i}'] = np.asarray(x)
np.savez(spec['dir'] + '/out.npz', **out)
'''


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
def soup(tmp_path_factory):
    """(the port's tree, each case's inputs, each call's Pallas outputs)."""
    jb = jtrace.make_device_geometry(tri_v=_random_tris(700, seed=11)).tri_bvh
    tb = convert.scene_from_numpy(jb, device='cpu')
    cases = {name: _case(name, tb) for name in CASES}
    arrays = {k: np.asarray(getattr(jb, k))
              for k in ('wbounds', 'wlinks', 'leaf_packed')}
    for name, (org, d, t0, ig, ig2) in cases.items():
        arrays.update({f'{name}/org': org, f'{name}/d': d,
                       f'{name}/t0': t0, f'{name}/ig': ig})
        if ig2 is not None:
            arrays[f'{name}/ig2'] = ig2
    tmp = str(tmp_path_factory.mktemp('pallas'))
    np.savez(os.path.join(tmp, 'in.npz'), **arrays)
    env = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS=(
        os.environ.get('XLA_FLAGS', '') + ' --xla_cpu_max_isa=AVX').strip())
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(
            os.pathsep) if p])
    subprocess.run([sys.executable, '-c', _CHILD,
                    json.dumps({'dir': tmp, 'cases': CASES})],
                   env=env, check=True, timeout=600, cwd=ROOT)
    got = np.load(os.path.join(tmp, 'out.npz'))
    pallas = {(name, mode): [got[f'{name}/{mode}/{i}'] for i in range(7)]
              for name in CASES for mode in ('closest', 'any')}
    return tb, cases, pallas


def _closest_prims(tb, org, d, ig=None):
    T = torch.as_tensor
    return trace_cuda.traverse_tris_plain(
        tb.wbounds, tb.wlinks, tb.leaf_packed, T(org), T(d),
        T(np.full(len(org), FAR, np.float32)),
        None if ig is None else T(ig))[1].numpy().astype(np.int32)


def _case(name, tb):
    """(org, d, t_init, ignore_prim, ignore_prim2 or None) of one case."""
    n = 1500 if name == 'ragged_1500' else 2048
    org, d = _rays(n, 31 + CASES.index(name))
    g = np.random.default_rng(7 + CASES.index(name))
    t0 = np.full(n, FAR, np.float32)
    ig = np.full(n, -1, np.int32)
    ig2 = None
    if name == 'one_live_lane':
        live = np.arange(0, n, 128) + g.integers(0, 128, n // 128)
        t0[:] = 0.0
        t0[live] = np.where(np.arange(len(live)) % 2, FAR, 1.5)
    elif name == 'third_dead':
        t0[g.random(n) < 1 / 3] = 0.0
    elif name == 'dead_block':
        n = 3072
        org, d = _rays(n, 31 + CASES.index(name))
        t0 = np.full(n, FAR, np.float32)
        t0[1024:2048] = 0.0
        ig = np.full(n, -1, np.int32)
    elif name == 'partly_blocked':
        # short segments, most of them clear, among long ones that meet
        # a triangle
        t0 = np.where(g.random(n) < 0.6, 0.4, FAR).astype(np.float32)
    elif name == 'two_ignore_ids':
        ig = _closest_prims(tb, org, d)
        ig2 = _closest_prims(tb, org, d, ig)
        ig[::7] = -1
    return org, d, t0, ig, ig2


def _held(got, want, name):
    assert len(got) == 7, name
    n_blocks = -(-len(want[0]) // trace_cuda.BLOCK)
    assert got[5].shape == got[6].shape == (n_blocks,), name
    assert got[5].dtype == got[6].dtype == np.int32, name
    np.testing.assert_array_equal(got[5], want[5], err_msg=f'{name} iters')
    np.testing.assert_array_equal(got[6], want[6], err_msg=f'{name} leafs')
    np.testing.assert_array_equal(got[1], want[1], err_msg=f'{name} prim')
    np.testing.assert_array_equal(got[4], want[4], err_msg=f'{name} slot')
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=name)
    hit = got[1] >= 0
    np.testing.assert_allclose(got[2][hit], want[2][hit], atol=1e-5)
    np.testing.assert_allclose(got[3][hit], want[3][hit], atol=1e-5)


@pytest.mark.parametrize('any_hit', [False, True], ids=['closest', 'any'])
@pytest.mark.parametrize('name', CASES)
def test_union_walk_matches_pallas(soup, name, any_hit):
    tb, cases, pallas = soup
    org, d, t0, ig, ig2 = cases[name]
    want = pallas[(name, 'any' if any_hit else 'closest')]
    T = torch.as_tensor
    args = (T(org), T(d), T(t0), T(ig), None if ig2 is None else T(ig2))
    plain = trace_cuda.union_walk_plain(tb.wbounds, tb.wlinks,
                                        tb.leaf_packed, *args,
                                        any_hit=any_hit, tile_stats=True)
    _held([x.numpy() for x in plain[:7]], want, f'{name} union_walk_plain')
    wrapped = trace_cuda.traverse_tris(tb, *args, any_hit=any_hit,
                                       want_counters=True)
    _held([x.numpy() for x in wrapped], want, f'{name} traverse_tris')
    tile_iters, tile_leafs, live, inner_lanes, leaf_lanes = (
        x.numpy() for x in plain[7:])
    assert (tile_iters.reshape(-1, 8).sum(axis=1) == want[5]).all()
    assert (live == (np.pad(t0, (0, 8 * 128 * len(want[5]) - len(t0)))
                     .reshape(-1, 128) > 0).sum(axis=1)).all()
    # the lanes open at a pop: every live lane under closest-hit, fewer
    # once any-hit blocks some
    if any_hit:
        assert (inner_lanes <= tile_iters * live).all()
        assert (leaf_lanes <= tile_leafs * live).all()
    else:
        assert (inner_lanes == tile_iters * live).all()
        assert (leaf_lanes == tile_leafs * live).all()
    if name == 'dead_block':
        # no live ray: each of the block's 8 tiles pops its root once
        assert want[5][1] == 8 and want[6][1] == 0
    if name == 'ragged_1500':
        # tiles 12-15 hold padded lanes only
        assert (tile_iters[12:] == 1).all() and (tile_leafs[12:] == 0).all()
    if name == 'partly_blocked' and any_hit:
        blocked = (want[1] >= 0).reshape(-1, 128)
        assert (blocked.any(axis=1) & ~blocked.all(axis=1)).all()
        assert (leaf_lanes < tile_leafs * live).any()
    if name == 'two_ignore_ids':
        assert ((ig >= 0) & (ig2 >= 0)).sum() > 300
        if not any_hit:
            hit = want[1] >= 0
            assert ((want[1] != ig) & (want[1] != ig2))[hit].all()
