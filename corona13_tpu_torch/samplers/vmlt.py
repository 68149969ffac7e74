"""Veach-MLT engine: a mutation registry over the primary-sample replay
(corona13_tpu/samplers/vmlt.py; the reference's src/pathspace/vmlt.c
:49-146 and its generated vmlt_registry.h).

Lockstep chains as in ``kmlt``; each chain draws a strategy by its
constant suitability weight, every strategy proposes in primary-sample
space, and one wavefront replay evaluates all chains:

  * ``largestep``: every dim drawn anew (vmlt_largestep.h); feeds the
    mean-brightness estimate b as kmlt's large steps do;
  * ``lens``: the exponential-kernel step on the image and aperture dims
    only (vmlt_lens.h);
  * ``multichain``: the exponential-kernel step on every dim (kmlt's small
    step).

Constant weights and symmetric kernels make the transition ratio 1, so
a = min(1, I_t / I_c).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pt as pt_mod
from .kmlt import _draws, _mutate_dim, advance, crnd, run_chains

# (name, weight): exploration (largestep) against local image-space and
# whole-path moves
REGISTRY = (('largestep', 0.30), ('lens', 0.35), ('multichain', 0.35))
LENS_DIMS = (0, 1, 4, 5)   # image x/y + aperture x/y (pt's PSS layout)
MULT = 0x85ebca6b          # sample-index hash multiplier of the chains
STUCK_LIMIT = 30000
# the strategy CDF in float32, in the JAX package's order (cumsum / sum)
_W = np.asarray([wt for _, wt in REGISTRY], np.float32)
CDF = tuple(float(c) for c in np.cumsum(_W, dtype=np.float32) / _W.sum())


def strategy(r_s):
    """Each chain's strategy index (0..2) from its uniform r_s: how many
    CDF entries lie below it (vmlt_mutate's suitability-weighted pick)."""
    return sum((r_s > c).to(torch.int64) for c in CDF)


def step(scene, cfg, carry, it, burn_in=8, stuck_limit=STUCK_LIMIT):
    """Mutation ``it`` (1-based) with a strategy drawn per chain."""
    strat = strategy(crnd(carry, it, 0, cfg))
    fresh, u1, u2 = _draws(carry, it, cfg)
    u = carry['u']
    small = _mutate_dim(u, u1, u2)
    dims = torch.arange(u.shape[1], device=u.device)
    lens = sum(dims == k for k in LENS_DIMS).to(torch.bool)
    u_t = torch.where((strat == 0)[:, None], fresh, torch.where(
        (strat == 1)[:, None], torch.where(lens[None, :], small, u), small))
    return advance(scene, cfg, carry, it, u_t, strat == 0, burn_in,
                   stuck_limit)


def render_sample(scene, cfg: pt_mod.PTConfig, sample_idx, batch: int = 1,
                  chains: int = 8192, burn_in: int = 8,
                  stuck_limit: int = STUCK_LIMIT):
    """One vmlt progression; returns the XYZ framebuffer [H, W, 3].  As
    ``kmlt.render_sample``, with the registry's proposal."""
    return run_chains(scene, cfg, sample_idx, batch, chains, burn_in,
                      stuck_limit, MULT, step)['image']
