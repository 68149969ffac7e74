"""RMSE comparison of two PFM images — the regression gate tool
(corona13_tpu/tools/pfmdiff.py; corona-13 tools/img/pfmdiff.c, used by
regression/createres.sh:22).

    python -m corona13_tpu_torch.tools.pfmdiff a.pfm b.pfm [--max-error 0.11]

Exit code 0 iff RMSE < max-error (the regression pass criterion).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import pfm


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def main(argv=None):
    p = argparse.ArgumentParser(prog='pfmdiff')
    p.add_argument('a')
    p.add_argument('b')
    p.add_argument('--max-error', type=float, default=0.11,
                   help='pass threshold (createres.sh default)')
    p.add_argument('--diff', default=None,
                   help='optional output difference image')
    args = p.parse_args(argv)
    ia = pfm.read_pfm(args.a)
    ib = pfm.read_pfm(args.b)
    if ia.shape != ib.shape:
        print(f'size mismatch: {ia.shape} vs {ib.shape}')
        return 2
    e = rmse(ia, ib)
    print(f'RMSE {e:.6f} (threshold {args.max_error})')
    if args.diff:
        pfm.write_pfm(args.diff, np.abs(ia - ib))
    return 0 if e < args.max_error else 1


if __name__ == '__main__':
    sys.exit(main())
