"""The progressive-preview traffic of a bidirectional path tracer: as
``progressive`` (one progression of ``render.render(scene, cfg, spp,
batch)`` a call, each with a seed of its own, the image on the host),
with the configuration's ``render`` keys naming ``sampler: bdpt``.

A program whose ``PTConfig`` has no ``sampler`` cannot run the traffic:
``setup`` raises before the scene loads.  ``check`` renders the sampled
calls again with the plain reference of bdpt (``reference/bdpt.py``);
``notes`` counts the rays of the traced call from the program's counters
(``tracing.counting()``: the lanes alive at each subpath bounce and the
lanes of each connection that trace a shadow ray).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import compare, scenes
from . import progressive


def strategy_calls(max_verts: int) -> tuple[int, int]:
    """Closest-hit and any-hit trace calls of a bdpt progression: a bounce
    of each subpath vertex (max_verts - 1 eye, max(max_verts - 3, 1)
    light), a shadow ray of each s >= 1, t >= 2 strategy with s + t <=
    max_verts and of each t = 1 strategy (``samplers/bdpt.py``)."""
    nt, nl = max_verts - 1, max(max_verts - 2, 1)
    dense = sum(1 for s in range(1, nl + 1) for t in range(2, nt + 2)
                if s + t <= max_verts)
    camera = sum(1 for s in range(1, nl + 1) if s + 1 <= max_verts)
    return nt + max(nl - 1, 1), dense + camera


class Driver(progressive.Driver):
    def setup(self):
        from corona13_tpu_torch.samplers import pt
        pt.PTConfig(**self.render_keys)     # a program without bdpt raises
        super().setup()

    def trace_extra(self, cfg_seed: int) -> dict:
        """As ``progressive``, with ``max_verts`` raised so that the
        ``trace_roofline`` reader, which keeps the first 2 x max_verts
        trace calls of each mode, keeps every one of a bdpt progression
        (8 closest-hit and 14 any-hit at max_verts 6), and with the film's
        ``pixels`` for the general splat's floor."""
        extra = super().trace_extra(cfg_seed)
        calls = max(strategy_calls(self.render_keys['max_verts']))
        extra.update(max_verts=max(extra['max_verts'], -(-calls // 2)),
                     pixels=self.render_keys['width']
                     * self.render_keys['height'])
        return extra

    def notes(self, cfg_seed: int):
        """Stderr lines of a traced run: the rays the traced call of
        ``cfg_seed`` traced and the share of its connection lanes still
        connected after the visibility test, from the program's counters
        (the call again, outside the window)."""
        from corona13_tpu_torch.tracing import counting
        with counting() as counters:
            self._render(cfg_seed)
        rows = counters.connections()
        rays = sum(counters.alive()) + sum(c for _, _, c, _, _ in rows)
        print(f'rays a progression (counters, the first traced call): '
              f'{rays}; connections (s, t, may connect, connected): '
              f'{[r[:4] for r in rows]}', file=sys.stderr, flush=True)

    def check(self, samples) -> dict:
        """The bdpt reference's progressions of the sampled calls against
        the program's: the worst ``compare.pixels_off`` over them."""
        from ..reference import bdpt as reference
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

