"""The plain reference of bdpt: a frozen copy of the port's bidirectional
path tracer (``tracer/samplers/bdpt.py``) over the reference's plain path,
which imports nothing of the program.

``progression`` renders what ``render.render(scene, cfg, spp, batch)``
renders in the program with ``cfg.sampler == 'bdpt'``: the sum of
``bdpt.render_sample`` over sample indices 0, 1, ... below spp, one a
step (the program runs bdpt one progression a step whatever ``batch``
says), the image on the host.  ``lowp=True`` is the control: the same
computation with each subpath vertex record's float tensors rounded to
bfloat16 as it is kept, the precision below the configuration's float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import SIDE, round_bf16
from .tracer.samplers import bdpt, pt

__all__ = ['SIDE', 'progression']


def config(render: dict, seed: int):
    """The reference's PTConfig of a configuration's ``render`` keys; the
    program's ``sampler`` key names this estimator, which the reference's
    PTConfig does not carry."""
    keys = {k: v for k, v in render.items() if k != 'sampler'}
    return pt.PTConfig(seed=seed, **keys)


def progression(sc, render: dict, seed: int, spp: int = 1, batch: int = 1,
                lowp: bool = False) -> np.ndarray:
    """The framebuffer [H, W, 3] (unnormalised XYZ) of ``spp`` bdpt
    progressions, float32 matrix products without TF32.  ``batch`` is
    taken for the signature of ``reference.progression``: bdpt's batch
    copies would trace the same paths, so each step is one progression."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(render, seed)
    fb = 0.0
    with torch.no_grad():
        for done in range(spp):
            fb = fb + bdpt.render_sample(
                sc, cfg, done, batch=1,
                round_record=round_bf16 if lowp else None)
    return fb.cpu().numpy()
