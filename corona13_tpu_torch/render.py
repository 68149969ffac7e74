"""Progressive rendering loop and output (corona13_tpu/render.py).

Progressions accumulate unnormalized splat sums into a framebuffer; the
stored image is fb * iso / (100 * progressions).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from . import tracing
from .io import pfm as pfm_io
from .samplers import bdpt as bdpt_mod
from .samplers import bdpt1 as bdpt1_mod
from .samplers import kmlt, lt, ppm, ptlt, vmlt
from .samplers import pt as pt_mod
from .spectral import colour

# the estimator of each ``PTConfig.sampler``: its step renders ``batch``
# progressions from a sample index, (scene, cfg, sample, batch=) -> their
# sum [H, W, 3]; only pt runs several a step.  bdpt1's also takes and
# returns its strategy table (``_bdpt1_step``).
SAMPLERS = {'pt': pt_mod.render_sample, 'bdpt': bdpt_mod.render_sample,
            'lt': lt.render_sample, 'ptlt': ptlt.render_sample,
            'bdpt1': bdpt1_mod.render_sample, 'ppm': ppm.render_sample,
            'kmlt': kmlt.render_sample, 'vmlt': vmlt.render_sample}


def _bdpt1_step(cfg):
    """bdpt1's step with a fresh strategy table, threaded from step to
    step."""
    table = bdpt1_mod.ConfigTable.create(cfg)

    def step(scene, cfg, sample, batch=1):
        nonlocal table
        fb, table = bdpt1_mod.render_sample(scene, cfg, sample, table,
                                            batch=batch)
        return fb
    return step


@dataclasses.dataclass
class RenderResult:
    fb: np.ndarray          # [H, W, 3] unnormalized XYZ sum
    spp: int
    iso: float
    seconds: float
    # per-depth alive lane counts of the first progression (None unless
    # the caller asked for the profile)
    path_hist: np.ndarray | None = None

    @property
    def image_xyz(self) -> np.ndarray:
        return self.fb * (self.iso / (100.0 * max(self.spp, 1)))

    @property
    def image_srgb(self) -> np.ndarray:
        lin = colour.convert(torch.as_tensor(self.image_xyz), 'xyz', 'srgb')
        return colour.srgb_gamma(lin).numpy()

    def write_pfm(self, path: str) -> None:
        pfm_io.write_pfm(path, self.image_xyz)

    def write_sidecar(self, path: str, extra: dict | None = None) -> None:
        """Per-render metadata text file (common_write_sidecar)."""
        with open(path, 'w') as f:
            f.write('corona13_tpu_torch render\n')
            f.write(f'spp      : {self.spp}\n')
            f.write(f'time     : {self.seconds:.2f}s total\n')
            if self.spp:
                f.write(f'         : {self.seconds / self.spp:.3f}s/progression\n')
            f.write(f'iso      : {self.iso}\n')
            if self.path_hist is not None and len(self.path_hist):
                bars = ' ▁▂▃▄▅▆▇█'
                top = max(int(self.path_hist[0]), 1)
                line = ''.join(
                    bars[min(8, int(9 * c / top))] for c in self.path_hist)
                f.write(f'pathlen  : [{line}] '
                        f'{[int(c) for c in self.path_hist]}\n')
            for k, v in (extra or {}).items():
                f.write(f'{k:9s}: {v}\n')


def render(scene, cfg: pt_mod.PTConfig, spp: int = 16, batch: int = 0,
           progress: bool = False, path_hist: bool = False,
           first: int = 0) -> RenderResult:
    """Render ``spp`` progressions (1 path/pixel each) on the scene's
    device with the estimator ``cfg.sampler`` names (``SAMPLERS``): 'pt'
    (pt or ptdl by ``cfg.use_nee``), 'bdpt', 'lt', 'ptlt', 'bdpt1', 'ppm',
    'kmlt' or 'vmlt' (``samplers/``).  ``batch`` progressions run per pt
    step (0 = auto: the whole spp for small images, else 1); the others
    run one a step (bdpt's batch copies share their sample ids and trace
    the same paths).  ``first``: the sample index of the first
    progression.  ``progress`` prints the time per frame after
    each step.  ``path_hist`` (pt only): the per-depth alive lanes of the
    first progression, from ``tracing`` counters of the first step (a
    dense wavefront; under cfg.compact from ``pt.alive_profile``, a second
    render)."""
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f'render: no sampler {cfg.sampler!r} '
                         f'({", ".join(SAMPLERS)})')
    if cfg.sampler == 'pt':
        step_fn = pt_mod.render_sample
        if batch <= 0:
            batch = spp if cfg.width * cfg.height * spp <= (1 << 21) else 1
        if not cfg.media and scene.has_media:
            # the scene carries participating media: run the media path
            cfg = cfg.replace(media=True)
    else:
        step_fn, batch = SAMPLERS[cfg.sampler], 1
        if cfg.sampler == 'bdpt1':
            step_fn = _bdpt1_step(cfg)
    batch = min(batch, spp)
    path_hist = path_hist and cfg.sampler == 'pt'
    dev = scene.device
    count = path_hist and cfg.compact is None
    counters = fb_host = None
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    t0 = time.perf_counter()
    done = 0
    with torch.no_grad():
        while done < spp:
            with contextlib.ExitStack() as step:
                step.enter_context(tracing.span(
                    'render.progression',
                    {'seed': cfg.seed, 'sample': first + done}))
                if count and done == 0:
                    counters = step.enter_context(
                        tracing.counting(lanes=cfg.width * cfg.height))
                fb = fb + step_fn(scene, cfg, first + done, batch=batch)
                done += batch
                if done >= spp:
                    with tracing.span('render.readback'):
                        fb_host = fb.cpu().numpy()
            if progress:
                if fb.is_cuda:
                    torch.cuda.synchronize(fb.device)
                print(f'  [{done}/{spp}] '
                      f'{(time.perf_counter() - t0) / done:.3f}s/frame',
                      flush=True)
        if fb_host is None:     # spp 0: no step ran
            fb_host = fb.cpu().numpy()
        seconds = time.perf_counter() - t0
        if counters is not None:
            hist = np.asarray(counters.alive(), dtype=np.int64)
        elif path_hist:
            hist = pt_mod.alive_profile(scene, cfg, first).cpu().numpy()
        else:
            hist = None
    return RenderResult(fb=fb_host, spp=done, iso=float(scene.camera.iso),
                        seconds=seconds, path_hist=hist)
