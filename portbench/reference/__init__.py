"""The plain reference of the benchmark: a frozen copy of the port's
plain path (``tracer/``, plain PyTorch: the skip-link and wide-tree walks
in torch in place of the CUDA kernels), which imports nothing of the
program and builds its own tree and tables from the benchmark's inputs.

``progression`` renders what ``render.render(scene, cfg, spp, batch)``
renders in the program: the sum of ``pt.render_sample`` over sample
indices 0, batch, 2 batch, ... below spp, the image on the host.  ``lowp=True`` is the control: the same
computation with the wavefront's float state rounded to bfloat16 after
every bounce, the precision below the configuration's float32.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .tracer import scene, testing
from .tracer.io import cam as cam_io
from .tracer.samplers import pt

SIDE = types.SimpleNamespace(scene=scene, assemble_scene=testing.assemble_scene,
                             cam_io=cam_io)


def round_bf16(state: dict) -> dict:
    """The wavefront state with every float32 tensor rounded to bfloat16."""
    return {k: v.to(torch.bfloat16).to(torch.float32)
            if torch.is_tensor(v) and v.dtype == torch.float32 else v
            for k, v in state.items()}


def config(render: dict, seed: int):
    """The reference's PTConfig of a configuration's ``render`` keys."""
    return pt.PTConfig(seed=seed, **render)


def progression(sc, render: dict, seed: int, spp: int = 1, batch: int = 1,
                lowp: bool = False) -> np.ndarray:
    """The framebuffer [H, W, 3] (unnormalised XYZ) of ``spp`` samples a
    pixel, ``batch`` at a time, float32 matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(render, seed)
    if not cfg.media and (sc.has_hete or bool(sc.materials.med_enabled.any())):
        cfg = cfg.replace(media=True)   # as render.render does
    batch = min(batch, spp)
    fb = 0.0
    with torch.no_grad():
        for done in range(0, spp, batch):
            fb = fb + pt.render_sample(
                sc, cfg, done, batch=batch,
                round_state=round_bf16 if lowp else None)
    return fb.cpu().numpy()
