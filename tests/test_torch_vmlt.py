"""The port's vmlt against the JAX package: the registry, the strategy CDF
in float32 and each chain's strategy (equal, CDF boundaries included),
the chains of ``render_sample`` at 16x12 with chains=32, burn_in=2 (seed
indices and accept masks against the JAX package's step as a loop, the
frame within 1e-4 of the largest pixel on >= 99% of pixels; measured:
every chain, every pixel), and port-only twins of tests/test_vmlt.py
(slow there): vmlt ~ pt, the weights sum to 1, the lens step moves the
lens dims only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu.samplers import kmlt as jkmlt
from corona13_tpu.samplers import vmlt as jvmlt
from corona13_tpu_torch import testing
from corona13_tpu_torch.samplers import kmlt
from corona13_tpu_torch.samplers import pt as pt_mod
from corona13_tpu_torch.samplers import vmlt
from test_torch_kmlt import chains_agree


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cdf():
    w = jnp.asarray([wt for _, wt in jvmlt.REGISTRY])
    return jnp.cumsum(w) / jnp.sum(w)


def _jax_strategy(r_s):
    """vmlt.py:81-83."""
    return jnp.sum((r_s[:, None] > _jax_cdf()[None, :]).astype(jnp.int32),
                   axis=1)


def test_registry_matches_jax():
    assert vmlt.REGISTRY == jvmlt.REGISTRY
    assert vmlt.LENS_DIMS == jvmlt.LENS_DIMS
    np.testing.assert_array_equal(np.float32(vmlt.CDF), np.asarray(_jax_cdf()))


def test_registry_weights_normalized():
    """tests/test_vmlt.py::test_registry_weights_normalized."""
    w = np.asarray([wt for _, wt in vmlt.REGISTRY])
    assert (w > 0).all()
    assert abs(w.sum() - 1.0) < 1e-6


def test_strategy_matches_jax():
    r = np.random.default_rng(0).uniform(0, 1, 1 << 16).astype(np.float32)
    cdf = np.asarray(_jax_cdf())
    # on and one ulp around each CDF entry below 1, and the ends of [0, 1)
    edges = cdf[:2]
    r[:8] = np.concatenate([np.nextafter(edges, 0), edges,
                            np.nextafter(edges, 2), [0.0, 1.0 - 2 ** -24]])
    got = vmlt.strategy(torch.as_tensor(r)).numpy()
    want = np.asarray(_jax_strategy(jnp.asarray(r)))
    np.testing.assert_array_equal(got, want)
    assert list(got[:8]) == [0, 1, 0, 1, 1, 2, 0, 2]
    share = np.bincount(got) / len(r)
    np.testing.assert_allclose(share, [0.30, 0.35, 0.35], atol=0.01)


def _jax_propose(r_s, u, fresh, u1, u2):
    """vmlt.py:81-100."""
    strat = _jax_strategy(r_s)
    small = jkmlt._mutate_dim(u, u1, u2)
    lens_mask = jnp.zeros((u.shape[1],), bool).at[
        jnp.asarray(jvmlt.LENS_DIMS)].set(True)
    lens = jnp.where(lens_mask[None, :], small, u)
    return jnp.where((strat == 0)[:, None], fresh,
                     jnp.where((strat == 1)[:, None], lens, small))


def test_vmlt_matches_jax():
    """Chains seeded, accepted and splatted as in the JAX package (16x12,
    chains=32, burn_in=2, max_verts=4, sample index 7)."""
    assert chains_agree(vmlt, jvmlt, 7, _jax_propose) >= 0.99


def test_lens_step_moves_only_the_lens_dims():
    """A chain whose strategy is ``lens`` keeps every dim but 0, 1, 4, 5;
    ``largestep`` chains count towards b and the others do not."""
    ts = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=16, height=12, max_verts=4, mf=2)
    carry = kmlt.init_chains(ts, cfg, 3, 256, vmlt.MULT)
    strat = vmlt.strategy(kmlt.crnd(carry, 1, 0, cfg))
    seen = {}
    real = kmlt.advance

    def spy(scene, cfg, carry, it, u_t, large, *a):
        seen.update(u_t=u_t, large=large)
        return real(scene, cfg, carry, it, u_t, large, *a)
    vmlt.advance = spy
    try:
        vmlt.step(ts, cfg, carry, 1)
    finally:
        vmlt.advance = real
    moved = seen['u_t'] != carry['u']
    lens = strat == 1
    assert lens.any() and (strat == 0).any() and (strat == 2).any()
    assert not moved[lens][:, [2, 3] + list(range(6, moved.shape[1]))].any()
    assert moved[lens][:, list(vmlt.LENS_DIMS)].all()
    assert moved[strat == 2].all()
    assert torch.equal(seen['large'], strat == 0)


def test_vmlt_matches_pt():
    """tests/test_vmlt.py::test_vmlt_matches_pt at its sizes and bounds."""
    cornell = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2,
                          use_nee=True)
    a = vmlt.render_sample(cornell, cfg, 0, batch=24, chains=512).numpy() / 24
    b = pt_mod.render_sample(cornell, cfg, 100, batch=32).numpy() / 32
    assert np.isfinite(a).all()
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.08, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.5, corr
