"""Every card-against-CPU reading of chip_smoke.py, alone, for one tree.

    python3 scripts/paths_vs_cpu.py [--root TREE] [--cells A,B] [--runs N]

Runs the comparisons of chip_smoke.py that hold the card's paths (the
kernels) against the CPU's (the plain versions) on the same scene and
sample index, each cell of ``chip_smoke.vs_cpu_cells`` through
``chip_smoke.cell_vs_cpu`` of the tree under test (its scene, size and
settings), and prints each share (paths whose accum agrees at rtol 1e-4 /
atol 1e-6) without holding it to a bar; ``light`` and ``mlt`` are
chip_smoke's lt, bdpt, ptlt and ppm, kmlt, vmlt comparisons (pixels
within 1e-4 of the largest), whose own checks stay.  ``--runs`` repeats
every reading.  The last line is a JSON object of the readings with the
card's name and power limit.  --root names another checkout whose
corona13_tpu_torch and chip_smoke.py to use (one that has
``chip_smoke.vs_cpu_cells``; to read two trees within one call on one
card, run this script once per tree, in turns); the default is this
script's own tree.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cs, dev):
    """Each cell's reading as a call, from chip_smoke ``cs``: its
    vs_cpu_cells, and its light-path and MLT comparisons."""
    out = {c: (lambda c=c: cs.cell_vs_cpu(c, dev, gate=False))
           for c in cs.vs_cpu_cells()}
    out['light'] = lambda: cs._light_vs_cpu(dev)
    out['mlt'] = lambda: cs._mlt_vs_cpu(dev)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--cells', default='')
    ap.add_argument('--runs', type=int, default=1)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script needs a GPU')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', os.path.join(root, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device('cuda')
    cells = readings(cs, dev)
    names = [c for c in args.cells.split(',') if c] or list(cells)
    out = {}
    for name in names:
        out[name] = []
        for _ in range(args.runs):
            try:
                out[name].append(cells[name]())
            except RuntimeError as e:   # a check of light / mlt: reported
                print(f'{name}: FAILED {e}', flush=True)
                out[name].append(f'failed: {e}')
    print(f'tree {root} on {card}', flush=True)
    print(json.dumps({'root': root, 'card': card, 'readings': out}),
          flush=True)


if __name__ == '__main__':
    main()
