"""Progressive rendering loop and output (corona13_tpu/render.py).

Progressions accumulate unnormalized splat sums into a framebuffer; the
stored image is fb * iso / (100 * progressions).
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from .io import pfm as pfm_io
from .samplers import pt as pt_mod
from .spectral import colour


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
           path_hist: bool = False) -> RenderResult:
    """Render ``spp`` progressions (1 path/pixel each) on the scene's
    device.  ``batch`` progressions run per step (0 = auto: the whole spp
    for small images, else 1)."""
    if batch <= 0:
        batch = spp if cfg.width * cfg.height * spp <= (1 << 21) else 1
    batch = min(batch, spp)
    if not cfg.media and (scene.has_hete
                          or bool(scene.materials.med_enabled.any())):
        cfg = cfg.replace(media=True)   # raises in the sampler: not ported
    dev = scene.device
    fb = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                     device=dev)
    t0 = _time.time()
    done = 0
    with torch.no_grad():
        while done < spp:
            fb = fb + pt_mod.render_sample(scene, cfg, done, batch=batch)
            done += batch
        fb_host = fb.cpu().numpy()
        seconds = _time.time() - t0
        hist = (pt_mod.alive_profile(scene, cfg, 0).cpu().numpy()
                if path_hist else None)
    return RenderResult(fb=fb_host, spp=done, iso=float(scene.camera.iso),
                        seconds=seconds, path_hist=hist)
