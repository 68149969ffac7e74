"""The progressive-preview traffic: one call is one progression of the
program, ``render.render(scene, cfg, spp, batch)``, ending with the image
on the host, as a preview's frame does.  Call k renders with
``cfg.seed`` drawn from the run's seed and k, so that no two calls
repeat; the warm-up calls draw theirs from a stream apart.

The traffic file gives ``spp``, ``batch``, ``warmup`` (calls before the
window, at the window's shapes), ``compare`` (calls of the window, drawn
from the seed, that the reference renders again) and ``trace_calls``
(calls in a traced window).  The configuration file gives the scene
(``scene``), the ``render`` keys of ``PTConfig`` and the ``limits`` of
the comparison (``portbench/compare.py``).
"""

from __future__ import annotations

import statistics
import sys
import types

import numpy as np
import torch

from .. import compare, scenes

M64 = (1 << 64) - 1
WARM_STREAM = 1 << 40


def call_seed(seed: int, k: int) -> int:
    """cfg.seed of call k: splitmix64 of (seed, k), cut to the 32 bits
    the port's counter RNG reads."""
    z = (seed * 0x9E3779B97F4A7C15 + k + 1) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def program_side():
    """The program's scene builders, as ``scenes.build`` takes them."""
    from corona13_tpu_torch import scene, testing
    from corona13_tpu_torch.io import cam as cam_io
    return types.SimpleNamespace(scene=scene, cam_io=cam_io,
                                 assemble_scene=testing.assemble_scene)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root: str, size=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.root = torch.device(device), root
        self.render_keys = dict(config['render'])
        if size is not None:
            self.render_keys.update(width=size[0], height=size[1])
        self.scene = None

    # -- the program -------------------------------------------------------

    def setup(self):
        from corona13_tpu_torch.samplers import pt
        self._pt = pt
        self.scene = scenes.build(self.config['scene'], program_side(),
                                  self.root, self.device,
                                  self.render_keys['width'],
                                  self.render_keys['height'])

    def _render(self, cfg_seed: int):
        from corona13_tpu_torch import render
        cfg = self._pt.PTConfig(seed=cfg_seed, **self.render_keys)
        return render.render(self.scene, cfg, spp=self.traffic['spp'],
                             batch=self.traffic['batch']).fb

    def warm(self):
        for i in range(self.traffic['warmup']):
            self._render(call_seed(self.seed, WARM_STREAM + i))

    def call(self, k: int):
        """Call k of the window: its cfg.seed and the image on the host."""
        s = call_seed(self.seed, k)
        return s, self._render(s)

    def trace_extra(self, cfg_seed: int) -> dict:
        """What the per-layer readers take besides the trace: the traced
        call of ``cfg_seed`` again, its rays and depth."""
        return dict(frame=lambda: self._render(cfg_seed),
                    lanes=self.render_keys['width'] * self.render_keys['height'],
                    max_verts=self.render_keys['max_verts'])

    def notes(self, cfg_seed: int):
        """Stderr lines of a traced run: the rays the traced call of
        ``cfg_seed`` traced (``pt.count_rays``, outside the window)."""
        cfg = self._pt.PTConfig(seed=cfg_seed, **self.render_keys)
        if not cfg.media and (self.scene.has_hete or bool(
                self.scene.materials.med_enabled.any())):
            cfg = cfg.replace(media=True)    # as render.render does
        n = cfg.width * cfg.height
        with torch.no_grad():
            rays = int(self._pt.count_rays(self.scene, cfg, 0, torch.arange(
                n, dtype=torch.int64, device=self.device)))
        print(f'rays a progression (pt.count_rays, the first traced call): '
              f'{rays}', file=sys.stderr, flush=True)

    def release(self):
        self.scene = None

    # -- the metrics ---------------------------------------------------------

    @staticmethod
    def end_to_end(times, window_s) -> dict:
        """frame_s: the window over the progressions completed in it;
        frame_p90_s: the 90th percentile of their times."""
        p90 = (statistics.quantiles(times, n=10, method='inclusive')[-1]
               if len(times) > 1 else times[0])
        return {'frame_s': (window_s / len(times), 's'),
                'frame_p90_s': (p90, 's')}

    # -- the comparison ------------------------------------------------------

    def check(self, samples) -> dict:
        """The reference's progressions of the sampled calls against the
        program's: the worst ``compare.pixels_off`` over them."""
        from .. import reference
        ref_scene = scenes.build(self.config['scene'], reference.SIDE,
                                 self.root, self.device,
                                 self.render_keys['width'],
                                 self.render_keys['height'])
        worst = 0.0
        for cfg_seed, img in samples:
            ref = reference.progression(ref_scene, self.render_keys, cfg_seed,
                                        self.traffic['spp'],
                                        self.traffic['batch'])
            worst = max(worst, compare.pixels_off(np.asarray(img), ref))
        return {'pixels_off': (worst, self.config['limits']['pixels_off'])}
