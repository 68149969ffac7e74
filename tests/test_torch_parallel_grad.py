"""The port's sharded train step (corona13_tpu_torch.parallel.shard) against
``jax.grad`` of the same loss written over the JAX package's single-device
``render_sample``, at the tolerances of tests/test_torch_grad.py (1e-3 for
the linear parameters, 5e-3 for the nonlinear ones).  JAX compiles the
gradient for about a minute on one core, so it has a file of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from corona13_tpu import testing as jtesting
from corona13_tpu.parallel import shard as jshard
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch.parallel import shard
from corona13_tpu_torch.samplers import pt as pt_mod

MEDIA = dict(width=16, height=8, max_verts=8, mf=2, use_nee=True, media=True)
RTOL, ATOL = 2e-4, 1e-5


def test_train_step_theta_matches_jax():
    """Gradients of the L2 loss over the serial (2, 2) mesh equal jax.grad
    of the same loss over the JAX package's render_sample of samples 0 and
    1, for the full apply_theta set in one jax.grad call: d_mul (a vector)
    and e_mul to 1e-3, med_sigma and focus to 5e-3, on the subsurface
    cornell with media on."""
    js = jtesting.cornell_scene(sphere='subsurf')
    ts = convert.scene_from_numpy(js, device='cpu')
    n_mats = int(js.materials.d_mul.shape[0])
    rng = np.random.default_rng(1)
    theta_np = {'d_mul': rng.uniform(0.9, 1.1, n_mats).astype(np.float32),
                'e_mul': np.float32(1.05), 'med_sigma': np.float32(0.9),
                'focus': np.float32(1.02)}
    target = np.random.default_rng(2).uniform(0.0, 0.05, (8, 16, 3)).astype(
        np.float32)
    scale = float(js.camera.iso) / (100.0 * 2)
    cfg_j = jpt.PTConfig(**MEDIA)

    def loss_fn(th):
        sc = jshard.apply_theta(js, th)
        fb = jpt.render_sample(sc, cfg_j, jnp.uint32(0), batch=2)
        img = fb * scale
        return jnp.mean((img - jnp.asarray(target)) ** 2), img
    (lj, imgj), gj = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in theta_np.items()})
    (lt, imgt), gt = shard.train_step_theta(
        ts, pt_mod.PTConfig(**MEDIA), shard.make_mesh(2, 2), target,
        {k: torch.as_tensor(v) for k, v in theta_np.items()},
        emulate=True, device='cpu')
    np.testing.assert_allclose(imgt.numpy(), np.asarray(imgj), rtol=RTOL,
                               atol=ATOL * scale)
    assert abs(float(lt) - float(lj)) <= 1e-4 * float(lj)
    for k, tol in (('d_mul', 1e-3), ('e_mul', 1e-3), ('med_sigma', 5e-3),
                   ('focus', 5e-3)):
        a, b = gt[k].numpy(), np.asarray(gj[k])
        assert np.isfinite(a).all() and np.abs(b).max() > 0, k
        assert a.shape == b.shape, k
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (k, a, b, err)
