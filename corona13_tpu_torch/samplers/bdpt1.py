"""BDPT with a single connection per progression
(corona13_tpu/samplers/bdpt1.py).

An adaptive table of running mean contributions, one entry per strategy,
lives on the host; each progression picks one strategy (s, t) for the
whole wavefront from it and runs the bdpt machinery restricted to that
connection (``bdpt.render_sample(only=(s, t))``).  The estimator divides
by the selection probability, so the accumulated framebuffer normalizes
like full bdpt; the table steers the selection toward high-contribution
strategies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng as rng_mod
from . import bdpt as bdpt_mod
from .pt import PTConfig


def strategies(cfg: PTConfig):
    """All implemented (s, t) strategies for the config, in the order of
    the loops of bdpt.render_sample."""
    NT = cfg.max_verts - 1
    NL = max(cfg.max_verts - 2, 1)
    out = []
    for t in range(2, NT + 2):
        out.append((0, t))
    for s in range(1, NL + 1):
        for t in range(2, NT + 2):
            if s + t <= cfg.max_verts:
                out.append((s, t))
    for s in range(1, NL + 1):
        if s + 1 <= cfg.max_verts:
            out.append((s, 1))
    return out


@dataclasses.dataclass
class ConfigTable:
    """Host-side running mean contribution per strategy."""
    strategies: list
    mean: np.ndarray     # running mean contribution per strategy
    count: np.ndarray

    @classmethod
    def create(cls, cfg: PTConfig):
        st = strategies(cfg)
        return cls(strategies=st, mean=np.ones(len(st)),
                   count=np.zeros(len(st)))

    def probs(self) -> np.ndarray:
        # explore floor: never let a strategy starve
        p = np.maximum(self.mean, 1e-3 * max(self.mean.max(), 1e-30))
        return p / p.sum()

    def update(self, idx: int, contrib: float):
        c = self.count[idx]
        self.mean[idx] = self.mean[idx] * (c / (c + 1.0)) + contrib / (c + 1.0)
        self.count[idx] += 1


def pick(cfg: PTConfig, sample_idx: int, table: ConfigTable):
    """The strategy index for progression ``sample_idx`` and the selection
    probabilities: one uniform of the counter RNG keyed by the sample
    index (reproducible by construction), computed on the host."""
    p = table.probs()
    u = float(rng_mod.uniform(torch.zeros(1, dtype=torch.int64), sample_idx,
                              int(rng_mod.Dim.LIGHTSOURCE) + 7919,
                              cfg.seed)[0])
    idx = int(np.searchsorted(np.cumsum(p), u * p.sum()))
    return min(idx, len(p) - 1), p


def render_sample(scene, cfg: PTConfig, sample_idx: int, table: ConfigTable,
                  batch: int = 1):
    """One bdpt1 progression: pick one strategy from the table, render it,
    update the table from the frame's mean (one float read back).  Returns
    (fb [H, W, 3], table)."""
    idx, p = pick(cfg, sample_idx, table)
    s, t = table.strategies[idx]
    fb = bdpt_mod.render_sample(scene, cfg, sample_idx, batch=batch,
                                only=(s, t))
    fb = fb / p[idx]
    table.update(idx, float(torch.mean(fb[..., 1])) * p[idx])
    return fb, table
