"""Kelemen-style primary-sample-space MLT (corona13_tpu/samplers/kmlt.py).

A batch of independent chains advances in lockstep: every mutation
re-runs the wavefront path tracer on an explicit primary-sample array
(``pt._sample_paths_full(u=...)``), the reference kmlt's semantics
(corona-13 src/pointsampler.d/kmlt.c):

  * large-step probability 0.2 (``P_LARGE_STEP``);
  * small steps perturb every dim with the exponential kernel
    r' = r -/+ s2 * exp(-log(s2/s1) * u), wrapped to [0, 1);
  * acceptance a = min(1, I_t / I_c) on the luminance Y;
  * the current and the tentative state both splat, weighted (1-a) and a
    over their own brightness;
  * the mean brightness b comes from large steps only and is the global
    gain.

The JAX package's ``lax.scan`` over mutations is a Python loop over
``step``; one step makes no synchronizing call (its counters stay on the
device), so a step could be captured as one CUDA graph.  Burn-in steps
move the chains and splat nothing (the JAX package splats them with
weight 0).
"""

from __future__ import annotations

import torch

from ..ops import rng
from ..ops import splat as splat_mod
from ..spectral import cie
from . import pt as pt_mod

P_LARGE_STEP = 0.2
# the reference's per-dim exponential step sizes (kmlt.c mutate scales)
S1, S2 = 1.0 / 1024.0, 1.0 / 64.0
MULT = 0x9e3779b9          # sample-index hash multiplier of the chains
STUCK_LIMIT = 40000
_LOG_S2_S1 = float(torch.log(torch.tensor(S2 / S1)))   # float32, as XLA's


def _mutate_dim(r, u1, u2):
    """One exponential-kernel perturbation with wraparound (kmlt.c:41-64)."""
    dv = S2 * torch.exp(-_LOG_S2_S1 * u1)
    r2 = torch.where(u2 < 0.5, r + dv, r - dv)
    return r2 - torch.floor(r2)


def _eval(scene, cfg, u):
    """Run the path tracer on primary samples u [C, D]; returns
    (pix_i, pix_j, xyz [C, 3], brightness [C])."""
    zero = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    accum, lam, pi, pj, _ = pt_mod._sample_paths_full(scene, cfg, zero, zero,
                                                      u=u)
    xyz = cie.spectral_to_xyz(lam, pt_mod._finite(accum))
    return pi, pj, xyz, torch.clamp(xyz[..., 1], min=0.0)


def _draws(carry, it, cfg):
    """The d-dim fresh sample and the two uniforms of the small step of
    mutation ``it``, for every chain: [C, d] each, one hash launch."""
    d = carry['u'].shape[1]
    dims = torch.arange(200, 200 + 3 * d, device=carry['cid'].device)
    r = rng.uniform(carry['cid'][:, None], carry['base'] + it, dims[None, :],
                    cfg.seed)
    return r[:, :d], r[:, d:2 * d], r[:, 2 * d:]


def crnd(carry, it, k, cfg):
    """The chains' k-th scalar uniform of mutation ``it``."""
    return rng.uniform(carry['cid'], carry['base'] + it, k, cfg.seed)


def init_chains(scene, cfg, sample_idx, chains, mult):
    """One large step per chain, then stationary seeding: the start states
    are resampled from that pool in proportion to their brightness (kmlt.py
    :80-101).  b's running sums start from the unweighted pool.  ``mult``:
    the sampler's sample-index hash multiplier."""
    dev = scene.device
    d = pt_mod.psd_dims(cfg.max_verts)
    cid = torch.arange(chains, dtype=torch.int64, device=dev)
    base = (int(sample_idx) * mult) & rng.M32
    u0 = rng.uniform(cid[:, None], base,
                     torch.arange(100, 100 + d, device=dev)[None, :],
                     cfg.seed)
    pi0, pj0, xyz0, i0 = _eval(scene, cfg, u0)
    b_sum0 = torch.sum(i0)
    cdf0 = torch.cumsum(i0, 0)
    tot0 = cdf0[-1]
    r0 = rng.uniform(cid, base, 9999, cfg.seed) * tot0
    idx0 = torch.clamp(torch.searchsorted(cdf0, r0), 0, chains - 1)
    idx0 = torch.where(tot0 > 0.0, idx0, cid)
    return dict(cid=cid, base=base, u=u0[idx0], pi=pi0[idx0], pj=pj0[idx0],
                xyz=xyz0[idx0], i=i0[idx0],
                fb=torch.zeros((cfg.height, cfg.width, 3),
                               dtype=torch.float32, device=dev),
                b_sum=b_sum0, b_cnt=torch.full((), float(chains), device=dev),
                rejects=torch.zeros(chains, dtype=torch.int64, device=dev))


def advance(scene, cfg, carry, it, u_t, large, burn_in, stuck_limit):
    """Evaluate the proposal u_t, add the large steps to b, splat both
    states after burn-in, accept or reject (a forced accept after
    ``stuck_limit`` rejections); returns the new carry."""
    pi_t, pj_t, xyz_t, i_t = _eval(scene, cfg, u_t)
    i_cur = carry['i']
    out = dict(carry)
    out['b_sum'] = carry['b_sum'] + torch.sum(torch.where(large, i_t, 0.0))
    out['b_cnt'] = carry['b_cnt'] + torch.sum(large.to(torch.float32))
    a = torch.clamp(torch.where(
        i_cur > 0.0, i_t / torch.clamp(i_cur, min=1e-30), 1.0), max=1.0)
    if it > burn_in:
        w_cur = torch.where(i_cur > 0.0,
                            (1.0 - a) / torch.clamp(i_cur, min=1e-30), 0.0)
        w_t = torch.where(i_t > 0.0, a / torch.clamp(i_t, min=1e-30), 0.0)
        fb = splat_mod.splat(carry['fb'], carry['pi'], carry['pj'],
                             carry['xyz'] * w_cur[:, None])
        out['fb'] = splat_mod.splat(fb, pi_t, pj_t, xyz_t * w_t[:, None])
    acc = (crnd(carry, it, 1, cfg) < a) | (carry['rejects'] >= stuck_limit)
    out['rejects'] = torch.where(acc, 0, carry['rejects'] + 1)
    out['u'] = torch.where(acc[:, None], u_t, carry['u'])
    out['xyz'] = torch.where(acc[:, None], xyz_t, carry['xyz'])
    for k, new in (('pi', pi_t), ('pj', pj_t), ('i', i_t)):
        out[k] = torch.where(acc, new, carry[k])
    return out


def step(scene, cfg, carry, it, burn_in=8, stuck_limit=STUCK_LIMIT):
    """Mutation ``it`` (1-based): a large step with probability 0.2, else
    the small step of every dim."""
    large = crnd(carry, it, 0, cfg) < P_LARGE_STEP
    fresh, u1, u2 = _draws(carry, it, cfg)
    u_t = torch.where(large[:, None], fresh, _mutate_dim(carry['u'], u1, u2))
    return advance(scene, cfg, carry, it, u_t, large, burn_in, stuck_limit)


def run_chains(scene, cfg, sample_idx, batch, chains, burn_in, stuck_limit,
               mult, step_fn):
    """The driver both MLT samplers share: seed, burn_in + n_mut steps of
    ``step_fn``, and the gain that normalizes the splats like ``batch`` pt
    progressions of width*height samples.  Returns the final chain state
    with the frame [H, W, 3] under 'image'."""
    n_mut = max(1, (cfg.width * cfg.height * batch) // chains)
    carry = init_chains(scene, cfg, sample_idx, chains, mult)
    for it in range(1, n_mut + burn_in + 1):
        carry = step_fn(scene, cfg, carry, it, burn_in, stuck_limit)
    b = carry['b_sum'] / torch.clamp(carry['b_cnt'], min=1.0)
    carry['image'] = carry['fb'] * (b * (cfg.width * cfg.height * batch)
                                    / (chains * n_mut))
    return carry


def render_sample(scene, cfg: pt_mod.PTConfig, sample_idx, batch: int = 1,
                  chains: int = 8192, burn_in: int = 8,
                  stuck_limit: int = STUCK_LIMIT):
    """One kmlt progression: enough mutations that the splat count matches
    batch * width * height; returns the XYZ framebuffer [H, W, 3].

    Chains are seeded anew for every sample index from the counter RNG;
    the first ``burn_in`` mutations only move them; ``stuck_limit``
    consecutive rejections force an accept (kmlt.c:276)."""
    return run_chains(scene, cfg, sample_idx, batch, chains, burn_in,
                      stuck_limit, MULT, step)['image']

