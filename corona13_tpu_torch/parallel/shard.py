"""Multi-card rendering: pixel and sample sharding over torch.distributed
(corona13_tpu/parallel/shard.py).

The reference is a single-node pthread renderer whose one parallel axis is
the atomic sample counter (corona-13 include/threads.h:31-34,
src/view.c:618-645).  Its two axes become a ('sp', 'px') mesh of ranks,
one process a card:

  * ``px``: the pixel wavefront is split into contiguous chunks; each rank
    traces its chunk, splats it into a framebuffer of its own, and the
    framebuffers are summed by ``all_reduce`` (the analogue of the atomic
    FB splats, corona_common.h:316-343, but deterministic);
  * ``sp``: independent progressions (sample indices) run side by side,
    like the reference's ``--batch N`` progressions per display sync
    (src/main.c:268-276).

The scene is replicated on every rank.  Rank r sits at ``sp = r // n_px``,
``px = r % n_px`` (the JAX package reshapes its devices row-major).  What a
rank renders is a pure function of (scene, cfg, mesh, sample_base, rank):
``render_shard``.  ``emulate=True`` runs every rank of the mesh in this
process, one after the other, and sums them in rank order; without it the
sum is an ``all_reduce`` over the default process group (NCCL on the card,
gloo on the CPU).

Gradients.  JAX's ``shard_map`` transpose all-reduces the parameter
gradients implicitly.  Here each rank back-propagates the loss's gradient
with respect to the summed image through its own framebuffer, and the
parameter gradients are all-reduced explicitly: an autograd-aware
``all_reduce`` under a loss that every rank computes would sum the same
dL/dimg from every rank and scale the gradient by the world size.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..ops import splat as splat_mod
from ..samplers import pt as pt_mod
from ..spectral import cie


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_sp sample rows x n_px pixel columns of ranks."""
    n_sp: int
    n_px: int

    @property
    def shape(self) -> dict:
        return {'sp': self.n_sp, 'px': self.n_px}

    @property
    def size(self) -> int:
        return self.n_sp * self.n_px

    def coords(self, rank: int) -> tuple[int, int]:
        """(sp, px) of ``rank``: row-major, as JAX reshapes its devices."""
        if not 0 <= rank < self.size:
            raise ValueError(f'rank {rank} outside a mesh of {self.size}')
        return divmod(rank, self.n_px)


def make_mesh(n_sp: int = 1, n_px: int | None = None,
              world_size: int | None = None) -> Mesh:
    """Mesh with axes ('sp', 'px'): sample-parallel x pixel-parallel.
    ``n_px`` defaults to the world size (the default process group's, 1
    without one) over ``n_sp``."""
    if n_px is None:
        if world_size is None:
            world_size = dist.get_world_size() if dist.is_initialized() else 1
        n_px = world_size // n_sp
    if n_sp < 1 or n_px < 1:
        raise ValueError(f'empty mesh: sp={n_sp}, px={n_px}')
    return Mesh(n_sp, n_px)


def rank_device(device='cuda') -> torch.device:
    """The device this rank renders on: ``cuda`` means the card of the
    local rank (torchrun's LOCAL_RANK, 0 without it); any other value is
    taken as given."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return device


def render_shard(scene, cfg: pt_mod.PTConfig, mesh: Mesh, sample_base,
                 rank: int) -> torch.Tensor:
    """The [H, W, 3] XYZ framebuffer of one rank before the reduction: its
    contiguous pixel chunk at sample index ``sample_base * n_sp + sp``,
    non-finite radiance zeroed, splatted by the general filter into a
    zero image.  Differentiable in the scene's tensors that require
    grad."""
    n = cfg.width * cfg.height
    if n % mesh.n_px:
        raise ValueError(f'pixel count {n} not divisible by px axis '
                         f'{mesh.n_px}')
    sp, px = mesh.coords(rank)
    chunk = n // mesh.n_px
    dev = scene.device
    pix = torch.arange(px * chunk, (px + 1) * chunk, dtype=torch.int64,
                       device=dev)
    accum, lam, pi, pj = pt_mod.sample_paths(
        scene, cfg, int(sample_base) * mesh.n_sp + sp, pix)
    accum = torch.where(torch.isfinite(accum), accum, 0.0)
    xyz = cie.spectral_to_xyz(lam, accum)
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    return splat_mod.splat(fb, pi, pj, xyz)


def _ranks(mesh: Mesh, scene, device, emulate: bool) -> list[int]:
    """The ranks this process renders: all of the mesh under ``emulate``,
    else its own rank in the default process group (0 without one, where
    the mesh must be of size 1).  The scene must already be on the rank's
    device: nothing is moved."""
    dev = rank_device(device)
    if scene.device != dev:
        raise ValueError(f'the scene is on {scene.device}, this rank renders '
                         f'on {dev}: build it with device={str(dev)!r}')
    if emulate:
        return list(range(mesh.size))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise ValueError(f'a mesh of {mesh.size} ranks over a world of '
                         f'{world} processes (emulate=True runs a mesh in '
                         f'one process)')
    return [dist.get_rank() if dist.is_initialized() else 0]


def _reduce(x: torch.Tensor, emulate: bool) -> torch.Tensor:
    if not emulate and dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def _sum(xs):
    out = xs[0].detach().clone()
    for x in xs[1:]:
        out += x.detach()
    return out


def render_samples_sharded(scene, cfg: pt_mod.PTConfig, mesh: Mesh,
                           sample_base, *, emulate: bool = False,
                           device='cuda') -> torch.Tensor:
    """One progression per 'sp' mesh row, pixels split over 'px'.

    Returns the [H, W, 3] XYZ accumulation summed over the whole mesh
    (``n_sp`` progressions worth of unnormalized splats), the same on every
    rank.  No autograd graph: ``train_step`` / ``train_step_theta`` are the
    differentiable entries."""
    ranks = _ranks(mesh, scene, device, emulate)
    with torch.no_grad():
        fbs = [render_shard(scene, cfg, mesh, sample_base, r) for r in ranks]
        return _reduce(_sum(fbs), emulate)


def apply_theta(scene, theta):
    """The scene with the inverse-rendering parameters applied: per-material
    albedo multipliers ``d_mul``, an emission scale ``e_mul``, a medium
    extinction scale ``med_sigma`` and the camera focus ``focus``."""
    mats = dataclasses.replace(
        scene.materials,
        d_mul=scene.materials.d_mul * theta['d_mul'],
        e_mul=scene.materials.e_mul * theta['e_mul'],
        med_mut_mul=scene.materials.med_mut_mul * theta['med_sigma'])
    cam = dataclasses.replace(scene.camera,
                              focus=scene.camera.focus * theta['focus'])
    return dataclasses.replace(scene, materials=mats, camera=cam)


def _apply_albedo_emission(scene, theta):
    mats = dataclasses.replace(
        scene.materials,
        d_mul=scene.materials.d_mul * theta['d_mul'],
        e_mul=scene.materials.e_mul * theta['e_mul'])
    return dataclasses.replace(scene, materials=mats)


def _step(scene, cfg, mesh, target, theta, sample_base, apply, emulate,
          device):
    """L2 loss of the summed image against ``target`` and its gradient in
    each entry of ``theta``: each rendered rank back-propagates dL/dimg
    through its own framebuffer; the per-rank gradients are summed in rank
    order, then over the process group."""
    ranks = _ranks(mesh, scene, device, emulate)
    dev = scene.device
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    with torch.enable_grad():
        leaves = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                  .detach().requires_grad_() for k, v in theta.items()}
        # one graph a rank (theta applied afresh), so that each backward
        # below walks its own rank's graph alone
        fbs = [render_shard(apply(scene, leaves), cfg, mesh, sample_base, r)
               for r in ranks]
        total = _reduce(_sum(fbs), emulate).requires_grad_()
        img = total * (scene.camera.iso / (100.0 * mesh.n_sp))
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, total)
        params = list(leaves.values())
        grads = None
        for fb in fbs:
            gr = torch.autograd.grad(fb, params, g, allow_unused=True)
            gr = [torch.zeros_like(p) if x is None else x
                  for p, x in zip(params, gr)]
            grads = gr if grads is None else [a + b for a, b in zip(grads, gr)]
    grads = {k: _reduce(x, emulate) for k, x in zip(leaves, grads)}
    return loss.detach(), img.detach(), grads


def train_step(scene, cfg: pt_mod.PTConfig, mesh: Mesh, target, theta,
               sample_base=0, *, emulate: bool = False, device='cuda'):
    """One differentiable-rendering step over the mesh: the materials'
    ``d_mul`` and ``e_mul`` scaled by ``theta``, the L2 loss of the image
    (``fb * iso / (100 * n_sp)``) against ``target`` [H, W, 3], and its
    gradients all-reduced.  Returns (loss, grads), ``grads`` keyed as
    ``theta``."""
    loss, _, grads = _step(scene, cfg, mesh, target, theta, sample_base,
                           _apply_albedo_emission, emulate, device)
    return loss, grads


def train_step_theta(scene, cfg: pt_mod.PTConfig, mesh: Mesh, target, theta,
                     sample_base=0, *, emulate: bool = False, device='cuda'):
    """The L2 loss and its gradients in the full ``apply_theta`` set
    (albedo vector, emission, medium sigma_t, focus), rendered over the
    mesh.  Returns ((loss, img), grads): the image rides along for
    checkpointing without a second render."""
    loss, img, grads = _step(scene, cfg, mesh, target, theta, sample_base,
                             apply_theta, emulate, device)
    return (loss, img), grads
