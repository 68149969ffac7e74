"""The port's sharded render and train step (corona13_tpu_torch.parallel)
against the JAX package's single-device renders.

The JAX package's own tests (tests/test_parallel.py) compare its
``shard_map`` render with ``pt.render_sample`` at rtol 2e-4, atol 1e-5;
compiling ``shard_map`` there takes minutes, so these tests hold the
port's shard sums to the JAX package's ``render_sample`` directly, at the
same tolerance.  A shard splats with the general filter (``splat.splat``),
``render_sample`` with the pixel-aligned stencil: the two agree up to
summation order, which the tolerance covers.  The gradients against
``jax.grad`` are in tests/test_torch_parallel_grad.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import testing
from corona13_tpu_torch.parallel import shard
from corona13_tpu_torch.samplers import pt as pt_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(width=16, height=8, max_verts=3, mf=1)
RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(scope='module')
def scenes(cornell):
    """The JAX package's cornell and the port's conversion of it."""
    return cornell, convert.scene_from_numpy(cornell, device='cpu')


@pytest.fixture(scope='module')
def jax_frames(scenes):
    """JAX ``render_sample`` at sample indices 0..3 (each computed once)."""
    cfg = jpt.PTConfig(**CFG)
    return [np.asarray(jpt.render_sample(scenes[0], cfg, jnp.uint32(s)))
            for s in range(4)]


def test_make_mesh():
    mesh = shard.make_mesh(n_sp=2, n_px=3)
    assert mesh.shape == {'sp': 2, 'px': 3} and mesh.size == 6
    # row-major, as the JAX package reshapes its devices
    assert [mesh.coords(r) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert shard.make_mesh().shape == {'sp': 1, 'px': 1}
    assert shard.make_mesh(n_sp=2, world_size=8).shape == {'sp': 2, 'px': 4}
    with pytest.raises(ValueError):
        mesh.coords(6)


@pytest.mark.parametrize('n_sp,n_px', [(2, 2), (1, 4), (4, 1)])
def test_sharded_matches_jax(scenes, jax_frames, n_sp, n_px):
    """The serial sum of every rank's framebuffer equals the sum of the JAX
    package's single-device renders over the mesh's sample indices."""
    _, ts = scenes
    cfg = pt_mod.PTConfig(**CFG)
    mesh = shard.make_mesh(n_sp=n_sp, n_px=n_px)
    fb = shard.render_samples_sharded(ts, cfg, mesh, 0, emulate=True,
                                      device='cpu')
    serial = sum(shard.render_shard(ts, cfg, mesh, 0, r)
                 for r in range(mesh.size))
    assert torch.equal(fb, serial)
    want = sum(jax_frames[:n_sp])
    assert want.max() > 0
    np.testing.assert_allclose(fb.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shards_split_pixels_and_samples(scenes, jax_frames):
    """A rank's pixels are its contiguous chunk: on mesh (1, 2) the two
    halves of the image rows get their light from their own rank (the
    filter spills across the seam only), and sample_base 1 of mesh (2, 1)
    renders the samples 2 and 3."""
    _, ts = scenes
    cfg = pt_mod.PTConfig(**CFG)
    mesh = shard.make_mesh(n_sp=1, n_px=2)
    top, bottom = (shard.render_shard(ts, cfg, mesh, 0, r) for r in (0, 1))
    assert float(top[:3].sum()) > 0 and float(top[6:].sum()) == 0
    assert float(bottom[5:].sum()) > 0 and float(bottom[:2].sum()) == 0
    fb = shard.render_samples_sharded(ts, cfg, shard.make_mesh(2, 1), 1,
                                      emulate=True, device='cpu')
    np.testing.assert_allclose(fb.numpy(), jax_frames[2] + jax_frames[3],
                               rtol=RTOL, atol=ATOL)


def test_sharded_refuses(scenes):
    """The reference's words where the pixels do not split; a mesh larger
    than the world; a scene that is not on the rank's device."""
    _, ts = scenes
    cfg = pt_mod.PTConfig(width=15, height=7, max_verts=3, mf=1)
    with pytest.raises(ValueError, match='pixel count 105 not divisible by '
                       'px axis 2'):
        shard.render_samples_sharded(ts, cfg, shard.make_mesh(1, 2), 0,
                                     emulate=True, device='cpu')
    cfg = pt_mod.PTConfig(**CFG)
    with pytest.raises(ValueError, match='a mesh of 4 ranks over a world of 1'):
        shard.render_samples_sharded(ts, cfg, shard.make_mesh(2, 2), 0,
                                     device='cpu')
    with pytest.raises(ValueError, match='the scene is on cpu'):
        shard.render_samples_sharded(ts, cfg, shard.make_mesh(), 0,
                                     device='meta')
    # a mesh of one rank needs no process group
    fb = shard.render_samples_sharded(ts, cfg, shard.make_mesh(), 0,
                                      device='cpu')
    assert fb.shape == (8, 16, 3) and float(fb.sum()) > 0


def test_pixel_aligned_splat_moves_carried_samples_reference_defect():
    """A reference defect that the sharded render does not share.
    ``render_sample`` recovers a lane's jitter as pix_i - floor(pix_i)
    (corona13_tpu/samplers/pt.py:897-899) and splats it around the lane's
    own pixel.  Where pixel + jitter rounds up to the next integer in
    float32 (511 + 0.99999 is 512.0), the jitter comes back as 0 and the
    sample lands one pixel short, at 511.0; a shard's general splat puts
    it at 512.0.  Both packages' pixel-aligned splats do the same.  At
    1024x576 this moves 16-18 samples a frame, so chip_smoke.py holds the
    sharded frame to render_sample only off their reach."""
    from corona13_tpu.ops import splat as jsplat
    from corona13_tpu_torch.ops import splat as tsplat
    w, h = 1024, 4
    lane = 1 * w + 511
    pi = (np.arange(w * h) % w).astype(np.float32) + np.float32(0.25)
    pj = (np.arange(w * h) // w).astype(np.float32) + np.float32(0.5)
    pi[lane] = np.float32(511.0) + np.float32(0.99999)
    assert pi[lane] == 512.0
    col = np.zeros((w * h, 3), np.float32)
    col[lane] = (1.0, 2.0, 3.0)
    jx, jy = pi - np.floor(pi), pj - np.floor(pj)
    assert jx[lane] == 0.0
    aligned = tsplat.splat_pixel_aligned(
        torch.zeros(h, w, 3), torch.as_tensor(jx), torch.as_tensor(jy),
        torch.as_tensor(col)).numpy()
    np.testing.assert_allclose(aligned, np.asarray(jsplat.splat_pixel_aligned(
        jnp.zeros((h, w, 3)), jnp.asarray(jx), jnp.asarray(jy),
        jnp.asarray(col))), rtol=1e-6, atol=1e-7)

    def general(x):
        return tsplat.splat(torch.zeros(h, w, 3), torch.tensor([x]),
                            torch.tensor([pj[lane]]),
                            torch.as_tensor(col[lane:lane + 1])).numpy()
    np.testing.assert_allclose(aligned, general(511.0), rtol=1e-5, atol=1e-7)
    assert np.abs(aligned - general(512.0)).max() > 0.1


def _target(shape, seed=0, scale=0.05):
    return np.random.default_rng(seed).uniform(
        0.0, scale, shape).astype(np.float32)


def _steps(ts, cfg, mesh, target, theta, step=shard.train_step_theta):
    out = step(ts, cfg, mesh, target, theta, emulate=True, device='cpu')
    return out[1]


def test_no_double_counting():
    """Mesh (1, 2) renders the samples of mesh (1, 1), split by pixels, so
    its gradient is (1, 1)'s, not twice it; the same for train_step.  The
    seam's pixels sum their taps in another order: 1e-4 for the linear
    parameters, 5e-3 for focus (a gradient of 5e-7 left by cancellation,
    the nonlinear tolerance of tests/test_torch_grad.py)."""
    ts = testing.cornell_scene(device='cpu')
    cfg = pt_mod.PTConfig(width=16, height=8, max_verts=4, mf=2)
    target = _target((8, 16, 3), seed=3)
    theta = {'d_mul': torch.ones(ts.materials.d_mul.shape[0]),
             'e_mul': torch.tensor(1.0), 'med_sigma': torch.tensor(1.0),
             'focus': torch.tensor(1.0)}
    one, two = (_steps(ts, cfg, shard.make_mesh(1, n), target, theta)
                for n in (1, 2))
    for k, tol in (('d_mul', 1e-4), ('e_mul', 1e-4), ('focus', 5e-3)):
        top = float(one[k].abs().max())
        assert top > 0, k
        assert float((two[k] - one[k]).abs().max()) <= tol * top, (
            k, two[k], one[k])
    th2 = {'d_mul': torch.tensor(1.0), 'e_mul': torch.tensor(1.0)}
    one, two = (_steps(ts, cfg, shard.make_mesh(1, n), target, th2,
                       shard.train_step) for n in (1, 2))
    for k in th2:
        np.testing.assert_allclose(float(two[k]), float(one[k]), rtol=1e-4)


def test_train_step_loss_goes_down():
    """train_step's loss is JAX's definition, and one step against the
    gradient lowers it."""
    ts = testing.cornell_scene(device='cpu')
    cfg = pt_mod.PTConfig(width=16, height=8, max_verts=4, mf=2)
    mesh = shard.make_mesh(1, 2)
    fb = shard.render_samples_sharded(ts, cfg, mesh, 0, emulate=True,
                                      device='cpu')
    target = fb * float(ts.camera.iso) / 100.0 * 0.8
    theta = {'d_mul': torch.tensor(1.0), 'e_mul': torch.tensor(1.0)}
    loss, grads = shard.train_step(ts, cfg, mesh, target, theta,
                                   emulate=True, device='cpu')
    img = fb * float(ts.camera.iso) / 100.0
    assert abs(float(loss) - float(torch.mean((img - target) ** 2))) \
        <= 1e-6 * float(loss)
    assert float(grads['e_mul']) > 0 and float(grads['d_mul']) > 0
    lower = {k: v - 0.2 * grads[k] / grads[k].abs() for k, v in theta.items()}
    loss2, _ = shard.train_step(ts, cfg, mesh, target, lower, emulate=True,
                                device='cpu')
    assert float(loss2) < float(loss)


_WORKER = """
import sys
import torch
import torch.distributed as dist
from corona13_tpu_torch import testing
from corona13_tpu_torch.parallel import shard
from corona13_tpu_torch.samplers import pt
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group('gloo', init_method='file://' + store, rank=rank,
                        world_size=2)
try:
    sc = testing.cornell_scene(device='cpu')
    cfg = pt.PTConfig(width=16, height=8, max_verts=4, mf=2)
    mesh = shard.make_mesh(1, 2)
    own = shard.render_shard(sc, cfg, mesh, 0, rank)
    fb = shard.render_samples_sharded(sc, cfg, mesh, 0, device='cpu')
    theta = {'d_mul': torch.ones(sc.materials.d_mul.shape[0]),
             'e_mul': torch.tensor(1.0), 'med_sigma': torch.tensor(1.0),
             'focus': torch.tensor(1.0)}
    target = torch.full((8, 16, 3), 0.01)
    (loss, img), grads = shard.train_step_theta(sc, cfg, mesh, target, theta,
                                                device='cpu')
    torch.save(dict(own=own, fb=fb, loss=loss, grads=grads), out)
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo(tmp_path):
    """Mesh (1, 2) over two gloo processes: the all-reduced framebuffer is
    bit-equal to the sum of the two ranks' own framebuffers, which equal
    render_shard here; the loss and the all-reduced gradients equal the
    serial emulation's (the real collective does not double count)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    store = str(tmp_path / 'store')
    procs = [subprocess.Popen(
        [sys.executable, '-c', _WORKER, str(r), store,
         str(tmp_path / f'rank{r}.pt')], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [torch.load(tmp_path / f'rank{r}.pt') for r in (0, 1)]
    assert torch.equal(got[0]['fb'], got[0]['own'] + got[1]['own'])
    assert torch.equal(got[1]['fb'], got[0]['fb'])
    sc = testing.cornell_scene(device='cpu')
    cfg = pt_mod.PTConfig(width=16, height=8, max_verts=4, mf=2)
    mesh = shard.make_mesh(1, 2)
    for r in (0, 1):
        np.testing.assert_allclose(
            got[r]['own'].numpy(),
            shard.render_shard(sc, cfg, mesh, 0, r).numpy(), rtol=1e-6,
            atol=1e-9)
    theta = {'d_mul': torch.ones(sc.materials.d_mul.shape[0]),
             'e_mul': torch.tensor(1.0), 'med_sigma': torch.tensor(1.0),
             'focus': torch.tensor(1.0)}
    (loss, _), grads = shard.train_step_theta(
        sc, cfg, mesh, torch.full((8, 16, 3), 0.01), theta, emulate=True,
        device='cpu')
    for g in got:
        assert abs(float(g['loss']) - float(loss)) <= 1e-6 * float(loss)
        for k, v in grads.items():
            assert float(v.abs().max()) > 0 or k == 'med_sigma', k
            np.testing.assert_allclose(g['grads'][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
