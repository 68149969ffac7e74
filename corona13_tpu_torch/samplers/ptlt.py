"""MIS-combined path tracer + next-event estimation + light tracer
(corona13_tpu/samplers/ptlt.py).

One eye path (splatting emitter hits and NEE connections) and one light
path (splatting camera connections) per sample, expressed through the bdpt
machinery restricted to exactly that strategy family:

    s = 0          (the eye path hits the emitter    - pt)
    s = 1, t >= 2  (light-sampled next event         - ptdl's family)
    t = 1          (the light path reaches the lens  - lt)

with the joint balance heuristic over the restricted set (bdpt's
``strategies=``), so the MIS denominators span exactly the computed
techniques and the estimator is unbiased.
"""

from __future__ import annotations

from . import bdpt as bdpt_mod
from .pt import PTConfig


def strategy_set(cfg: PTConfig) -> frozenset:
    NT = cfg.max_verts - 1
    NL = max(cfg.max_verts - 2, 1)
    out = set()
    for t in range(2, NT + 2):
        out.add((0, t))
        if 1 + t <= cfg.max_verts:
            out.add((1, t))
    for s in range(1, NL + 1):
        if s + 1 <= cfg.max_verts:
            out.add((s, 1))
    return frozenset(out)


def render_sample(scene, cfg: PTConfig, sample_idx, batch: int = 1):
    """One ptlt progression; returns the XYZ accumulation FB [H, W, 3]."""
    return bdpt_mod.render_sample(scene, cfg, sample_idx, batch=batch,
                                  strategies=strategy_set(cfg))
