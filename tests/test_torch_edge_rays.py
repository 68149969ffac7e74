"""The static triangle walks on rays aimed at edges two leaves share.

The JAX package walks static triangles with one of two paths: on the TPU
the Pallas kernel (``corona13_tpu/ops/trace_pallas.py``: a union walk over
128-ray tiles, the winner the minimum of (bits(t) & ~7) | row), elsewhere
XLA's skip-link ``_traverse`` (``_use_pallas`` is false off the TPU).  The
port's wide walk keeps the TPU kernel's order and winner
(``trace_cuda.traverse_tris_plain``, which the CUDA kernel equals bit for
bit: tests/test_torch_gpu.py); its deep form walks the skip links as
``_traverse`` does (``trace_plain.walk_plain``).

On rays aimed at edges that two leaves of the plane scene's tree share
(``chip_smoke.edge_rays``) a hit can lie an ulp before its own box's entry,
or two leaves can give the same t, and then the leaf a walk reaches first
wins.  There the three walks disagree, and the reference's two paths
disagree with each other: a named expected difference of the reference
(ROADMAP Queue 3), not a defect of the port.  This file pins on how many
of the 65,536 rays each pair differs in a bit of (t, prim, u, v, slot),
and on how many of those one walk hits and the other misses.  The port's
union walk (``trace_cuda.union_walk_plain``, what ``traverse_tris(...,
want_counters=True)`` runs) is the Pallas kernel's own walk of each
128-ray tile, so it is held to the Pallas kernel on every ray: 0 differ.
The Pallas kernel runs in interpret mode in a child process without FMA
(``--xla_cpu_max_isa=AVX``), as tests/test_torch_moving_form.py runs the
JAX package, so that it rounds operation by operation as torch does; on a
tie its result also depends on the other rays of its 128-ray tile.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corona13_tpu_torch import testing
from corona13_tpu_torch.ops import trace_cuda, trace_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1 << 16
MAX_DIST = 3.4e38

# rays (of N_RAYS, seed 21) on which two walks differ in a bit of (t,
# prim, u, v, slot): always in prim; on how many of them one walk hits
# and the other misses
PORT_VS_SKIP_LINKS = (4787, 0)
PALLAS_VS_SKIP_LINKS = (5210, 193)
PALLAS_VS_PORT = (447, 193)
# the port's union walk (trace_cuda.union_walk_plain: want_counters, the
# TPU kernel's own walk of each 128-ray tile) against the Pallas kernel
PALLAS_VS_UNION = (0, 0)

_CHILD = r'''
import json, sys
import numpy as np
import jax
jax.config.update('jax_default_device', jax.devices('cpu')[0])
import jax.numpy as jnp
from corona13_tpu.ops import trace_pallas
spec = json.loads(sys.argv[1])
a = np.load(spec['dir'] + '/in.npz')
n = a['org'].shape[0]
out = trace_pallas.traverse_tris(
    jnp.asarray(a['wbounds']), jnp.asarray(a['wlinks']),
    jnp.asarray(a['leaf_packed']), jnp.asarray(a['org']),
    jnp.asarray(a['d']), jnp.asarray(a['t']), jnp.full((n,), -1, jnp.int32),
    interpret=True)
np.savez(spec['dir'] + '/out.npz', *[np.asarray(x) for x in out])
'''


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process (the suite runs in xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _differ(a, b):
    """Rays on which any of two (t, prim, u, v, slot) differ in a bit."""
    out = np.zeros(len(_bits(a[0])), bool)
    for x, y in zip(a, b):
        out |= _bits(x) != _bits(y)
    return out


@pytest.fixture(scope='module')
def walks(tmp_path_factory):
    """(skip-link walk, the port's wide walk, the Pallas kernel, the port's
    union walk) on chip_smoke.edge_rays of the plane scene's static
    tree."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    geom = testing.plane_scene(device='cpu').geom
    b = geom.tri_bvh
    org, d, _, _ = cs.edge_rays(geom, N_RAYS, 21, torch.device('cpu'))
    t = torch.full((N_RAYS,), MAX_DIST)
    none = torch.full((N_RAYS,), -1, dtype=torch.long)
    skip = trace_plain.walk_plain(b, 'tri', org, d, t, none,
                                  torch.zeros(N_RAYS), torch.zeros(N_RAYS),
                                  none)
    port = trace_cuda.traverse_tris_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                          org, d, t)
    union = trace_cuda.union_walk_plain(b.wbounds, b.wlinks, b.leaf_packed,
                                        org, d, t)[:5]
    tmp = str(tmp_path_factory.mktemp('pallas'))
    np.savez(os.path.join(tmp, 'in.npz'), wbounds=b.wbounds.numpy(),
             wlinks=b.wlinks.numpy(), leaf_packed=b.leaf_packed.numpy(),
             org=org.numpy(), d=d.numpy(), t=t.numpy())
    env = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS=(
        os.environ.get('XLA_FLAGS', '') + ' --xla_cpu_max_isa=AVX').strip())
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(
            os.pathsep) if p])
    subprocess.run([sys.executable, '-c', _CHILD, json.dumps({'dir': tmp})],
                   env=env, check=True, timeout=300, cwd=ROOT)
    got = np.load(os.path.join(tmp, 'out.npz'))
    pallas = [got[f'arr_{i}'] for i in range(5)]
    return skip, port, pallas, union


def test_static_walk_edge_rays_reference_defect(walks):
    """The pinned counts: the port's wide walk (the TPU kernel's order and
    winner) against the skip-link walk (XLA's _traverse), and the Pallas
    kernel against each.  Every difference is one of prim; the port's walk
    and the skip-link walk hit the same rays, the Pallas kernel hits or
    misses 193 others on its own.  The port's union walk is the Pallas
    kernel's walk: it differs on no ray."""
    skip, port, pallas, union = walks
    assert (_bits(skip[1]) >= 0).mean() > 0.8
    pairs = {'port vs skip links': (port, skip, PORT_VS_SKIP_LINKS),
             'pallas vs skip links': (pallas, skip, PALLAS_VS_SKIP_LINKS),
             'pallas vs port': (pallas, port, PALLAS_VS_PORT),
             'pallas vs union': (pallas, union, PALLAS_VS_UNION)}
    for name, (a, b, (want, want_hit)) in pairs.items():
        off = _differ(a, b)
        pa, pb = _bits(a[1]), _bits(b[1])
        assert int(off.sum()) == want, (name, int(off.sum()))
        np.testing.assert_array_equal(off, pa != pb, err_msg=name)
        assert int(((pa >= 0) != (pb >= 0)).sum()) == want_hit, name
