"""Readings of the comparison that sets each cell's limits, in one process:

    python -m portbench.control --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--size WxH]

For each of ``--seeds``: the program renders the traffic's ``compare``
calls of a run with that seed (the calls 0, 1, ... of its window, at the
cell's own size and settings) and the reference renders them again; the
reading is the worst ``compare.pixels_off`` (the lower reading of the
limit).  For each of ``--control-seeds``: the control, the reference
computed with its wavefront rounded to bfloat16 after every bounce
(``reference.progression(lowp=True)``), stands in the program's place
against the reference on the same calls (the upper reading).  Prints
one line per reading and a JSON object last.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import compare, manifest, reference, run, scenes


def readings(workload, seeds, control_seeds, device, size=None):
    c = manifest.cell(workload)
    drv = manifest.driver(c['traffic'])(c['config'], c['traffic'], 0,
                                        device, manifest.ROOT, size)
    drv.setup()
    drv.warm()
    keys, traffic = drv.render_keys, c['traffic']
    ref_scene = scenes.build(c['config']['scene'], reference.SIDE,
                             manifest.ROOT, drv.device, keys['width'],
                             keys['height'])

    def ref(s, lowp=False):
        return reference.progression(ref_scene, keys, s, traffic['spp'],
                                     traffic['batch'], lowp=lowp)
    out = {'program': {}, 'control': {}}
    for seed in seeds:
        drv.seed = seed
        worst = 0.0
        for k in range(traffic['compare']):
            s, img = drv.call(k)
            worst = max(worst, compare.pixels_off(np.asarray(img), ref(s)))
        out['program'][seed] = worst
        print(f'{workload} program seed {seed}: pixels_off {worst!r}',
              flush=True)
    for seed in control_seeds:
        drv.seed = seed
        worst = 0.0
        for k in range(traffic['compare']):
            s = drv.call(k)[0]
            worst = max(worst, compare.pixels_off(ref(s, lowp=True), ref(s)))
        out['control'][seed] = worst
        print(f'{workload} control seed {seed}: pixels_off {worst!r}',
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--size', default='')
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(',') if x]
    size = tuple(int(x) for x in args.size.split('x')) if args.size else None
    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                   device, size)
    if device == 'cuda':
        print(f'card: {run.card_line()}', flush=True)
    print(json.dumps(dict(workload=args.workload, device=device, **out)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
