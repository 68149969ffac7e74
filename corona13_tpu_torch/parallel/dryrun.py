"""The multi-card inverse-rendering loop on small shapes
(``__graft_entry__.dryrun_multichip`` of the JAX package).

    python -m corona13_tpu_torch.parallel.dryrun [N] [--device cpu]
    torchrun --nproc_per_node=N -m corona13_tpu_torch.parallel.dryrun

Under torchrun every process is one rank of an N-card mesh (NCCL on the
card, gloo with ``--device cpu``); as a single process it runs an N-rank
mesh one rank after the other in that process (``shard``'s ``emulate``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .. import testing
from ..io import fb as fb_io
from ..samplers import pt as pt_mod
from ..utils.math import norm
from . import shard


def train_loop(scene, cfg: pt_mod.PTConfig, mesh: shard.Mesh, theta, ckpt,
               *, emulate: bool, device):
    """The inverse-rendering loop of ``dryrun_multichip``: a target at 0.85
    of the render at sample 0 and the initial ``theta``, then 3 Adam steps
    (lr 3e-2; torch's defaults are optax's) at sample bases 1, 2, 3; rank
    0 accumulates each step's render into the .fb file ``ckpt`` and reads
    it back.  Updates ``theta`` in place and returns the losses, the last
    gradients and the seconds of each step."""
    rank = 0 if emulate else dist.get_rank()
    kw = dict(emulate=emulate, device=device)
    scale = scene.camera.iso / (100.0 * mesh.n_sp)
    # target: a dimmed render at the initial parameters, so that gradient
    # descent must darken the image and the loss goes down
    target = shard.render_samples_sharded(
        shard.apply_theta(scene, theta), cfg, mesh, 0, **kw) * scale * 0.85
    params = [p.requires_grad_() for p in theta.values()]
    opt = torch.optim.Adam(params, lr=3e-2)
    losses, seconds = [], []
    for it in range(3):
        t0 = time.perf_counter()
        (loss, img), grads = shard.train_step_theta(
            scene, cfg, mesh, target, theta, sample_base=it + 1, **kw)
        assert torch.isfinite(loss), loss
        assert all(torch.isfinite(g).all() for g in grads.values()), grads
        for k, p in theta.items():
            p.grad = grads[k]
        opt.step()
        losses.append(float(loss))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if rank == 0:
            # checkpoint the step's render between optimizer steps and
            # read it back (the .fb is the checkpoint, framebuffer.h)
            fbf = fb_io.Framebuffer.open(ckpt, cfg.width, cfg.height,
                                         retain=True)
            fbf.accumulate(img.cpu().numpy(), mesh.n_sp)
            fbf.flush(iso=float(scene.camera.iso))
            back = fb_io.Framebuffer.load(ckpt)
            assert back.spp == (it + 1) * mesh.n_sp, back.spp
    return losses, grads, seconds


def dryrun_multichip(n_devices: int, *, device='cuda'):
    """The full training loop over an ('sp', 'px') mesh of n_devices ranks:
    cornell with a subsurface sphere (the JAX function's fallback scene,
    its 0010_pt being absent) at 256x144, max_verts=7, mf=2, NEE and media
    on; the parameters d_mul[M], e_mul, med_sigma and focus; ``train_loop``
    with a .fb checkpoint.  Asserts finite gradients and a last loss below
    the first; returns the losses, the last gradients and the seconds of
    each step."""
    emulate = not dist.is_initialized()
    if not emulate and dist.get_world_size() != n_devices:
        raise ValueError(f'dryrun_multichip({n_devices}) in a world of '
                         f'{dist.get_world_size()}')
    rank = 0 if emulate else dist.get_rank()
    dev = shard.rank_device(device)
    n_sp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = shard.make_mesh(n_sp=n_sp, n_px=n_devices // n_sp)
    scene = testing.cornell_scene(sphere='subsurf', device=dev)
    # max_verts=7 so that interior-medium paths reach a contributing
    # vertex and med_sigma's gradient is live
    cfg = pt_mod.PTConfig(width=256, height=144, max_verts=7, mf=2,
                          use_nee=True, media=True)
    n_mats = scene.materials.d_mul.shape[0]
    theta = {'d_mul': torch.ones(n_mats, device=dev),   # per-material albedo
             'e_mul': torch.tensor(1.0, device=dev),
             'med_sigma': torch.tensor(1.0, device=dev),
             'focus': torch.tensor(1.0, device=dev)}
    with tempfile.TemporaryDirectory() as tmp:
        losses, grads, seconds = train_loop(
            scene, cfg, mesh, theta, os.path.join(tmp, 'dryrun_multichip.fb'),
            emulate=emulate, device=dev)
    assert losses[-1] < losses[0], losses
    g_alb = float(norm(grads['d_mul'].reshape(-1)))
    if rank == 0:
        print(f'dryrun_multichip({n_devices}): mesh={mesh.shape} '
              f'scene=cornell_subsurf media=on params=(d_mul[{n_mats}],e_mul,'
              f'med_sigma,focus) adam_steps=3 '
              f'losses={["%.6f" % v for v in losses]} |g_albedo|={g_alb:.6f} '
              f'g_sigma={float(grads["med_sigma"]):.6f} '
              f'g_focus={float(grads["focus"]):.6f}', flush=True)
    return dict(mesh=mesh.shape, losses=losses, step_s=seconds,
                grads={k: v.detach().cpu() for k, v in grads.items()})


def main(argv=None):
    p = argparse.ArgumentParser(prog='corona13_tpu_torch.parallel.dryrun')
    p.add_argument('n', type=int, nargs='?', default=1,
                   help='ranks of the mesh when run as one process')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)
    if 'WORLD_SIZE' not in os.environ:
        dryrun_multichip(args.n, device=args.device)
        return 0
    # under torchrun: one rank a process, the address from its environment
    dev = shard.rank_device(args.device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo')
    try:
        dryrun_multichip(dist.get_world_size(), device=args.device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
