"""The port's multi-card training loop (corona13_tpu_torch.parallel.dryrun,
the twin of ``__graft_entry__.dryrun_multichip``) against the same loop
run live over the JAX package.

``__graft_entry__.dryrun_multichip`` renders through ``shard_map``, which
compiles for minutes on the CPU, so the JAX side here is that function's
loop written over the JAX package's single-device ``pt.render_sample``
(the samples of every 'sp' row in one batch) and optax, at 16x8: the
target at 0.85 of the render at sample 0, three ``optax.adam(3e-2)`` steps
at sample bases 1, 2, 3.  The port's ``train_loop`` runs the same loop
over an emulated mesh, its checkpoint included.

For the record, at the full 256x144 on the CPU the JAX package's
``dryrun_multichip`` printed the losses 0.012312, 0.017858, 0.009251 on
one device and 0.005695, 0.004800, 0.005095 on a 4-device mesh; the port
prints the same digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from corona13_tpu import testing as jtesting
from corona13_tpu.parallel import shard as jshard
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch.io import fb as fb_io
from corona13_tpu_torch.parallel import dryrun, shard
from corona13_tpu_torch.samplers import pt as pt_mod

# the dryrun's configuration at a width and height cut to 16x8
CFG = dict(width=16, height=8, max_verts=7, mf=2, use_nee=True, media=True)
MESHES = {1: (1, 1), 4: (2, 2)}   # dryrun_multichip's mesh of n devices


def _jax_loop(scene, n_sp):
    """``__graft_entry__.dryrun_multichip``'s loop over single-device
    renders: sample base s renders samples s*n_sp .. s*n_sp + n_sp - 1."""
    cfg = jpt.PTConfig(**CFG)
    scale = float(scene.camera.iso) / (100.0 * n_sp)

    def loss_fn(th, s, target):
        sc = jshard.apply_theta(scene, th)
        img = jpt.render_sample(sc, cfg, s * jnp.uint32(n_sp),
                                batch=n_sp) * scale
        return jnp.mean((img - target) ** 2), img

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    n_mats = scene.materials.d_mul.shape[0]
    theta = {'d_mul': jnp.ones((n_mats,)), 'e_mul': jnp.float32(1.0),
             'med_sigma': jnp.float32(1.0), 'focus': jnp.float32(1.0)}
    zero = jnp.zeros((cfg.height, cfg.width, 3))
    (_, img0), _ = step(theta, jnp.uint32(0), zero)
    target = img0 * 0.85
    opt = optax.adam(3e-2)
    opt_state = opt.init(theta)
    losses = []
    for it in range(3):
        (loss, _), grads = step(theta, jnp.uint32(it + 1), target)
        updates, opt_state = opt.update(grads, opt_state)
        theta = optax.apply_updates(theta, updates)
        losses.append(float(loss))
    return losses, theta, grads


@pytest.mark.parametrize('n_devices', [1, 4])
def test_dryrun_matches_jax_losses(n_devices, tmp_path):
    """The losses of the three steps within 1e-4 relative, the parameters
    after them within 1e-4 and the last gradients at the tolerances of
    tests/test_torch_grad.py (1e-3 for d_mul and e_mul, 5e-3 for
    med_sigma and focus); the checkpoint holds 3 steps of samples."""
    n_sp, n_px = MESHES[n_devices]
    js = jtesting.cornell_scene(sphere='subsurf')
    losses_j, theta_j, grads_j = _jax_loop(js, n_sp)

    ts = convert.scene_from_numpy(js, device='cpu')
    n_mats = ts.materials.d_mul.shape[0]
    theta = {'d_mul': torch.ones(n_mats), 'e_mul': torch.tensor(1.0),
             'med_sigma': torch.tensor(1.0), 'focus': torch.tensor(1.0)}
    ckpt = str(tmp_path / 'loop.fb')
    losses, grads, seconds = dryrun.train_loop(
        ts, pt_mod.PTConfig(**CFG), shard.make_mesh(n_sp, n_px), theta, ckpt,
        emulate=True, device=torch.device('cpu'))
    assert len(seconds) == 3

    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    for k in theta:
        np.testing.assert_allclose(theta[k].detach().numpy(),
                                   np.asarray(theta_j[k]), rtol=1e-4)
    for k, tol in (('d_mul', 1e-3), ('e_mul', 1e-3), ('med_sigma', 5e-3),
                   ('focus', 5e-3)):
        a, b = grads[k].numpy(), np.asarray(grads_j[k])
        assert np.isfinite(a).all() and np.abs(b).max() > 0, k
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (k, a, b, err)
    assert fb_io.Framebuffer.load(ckpt).spp == 3 * n_sp


def test_dryrun_four_ranks_emulated():
    """``dryrun_multichip(4)`` at its full size, the (sp, px) = (2, 2) mesh
    run rank after rank in one process: finite gradients of every
    parameter, a live med_sigma gradient, the last loss below the first
    and the checkpoint read back (asserted inside)."""
    out = dryrun.dryrun_multichip(4, device='cpu')
    assert out['mesh'] == {'sp': 2, 'px': 2}
    assert len(out['losses']) == 3 and out['losses'][-1] < out['losses'][0]
    assert out['grads']['d_mul'].shape == (5,)
    assert all(torch.isfinite(g).all() for g in out['grads'].values())
    assert float(out['grads']['med_sigma']) != 0.0
