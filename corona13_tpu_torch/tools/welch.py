"""Welch t-test comparison of two renders — 'allclose with noise'
(corona13_tpu/tools/welch.py; corona-13 view.c:60-64,667-686 block
variance buffers + tools/img/welch.c): images are reduced to 32x32-block means/variances and
compared with a two-sample t statistic; blocks with |t| above the
threshold are statistically significantly different.

    python -m corona13_tpu_torch.tools.welch a.pfm b.pfm [--threshold 4.0]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import pfm

BLOCK = 32


def block_stats(img: np.ndarray):
    """Mean and variance of luminance per 32x32 block."""
    y = np.asarray(img)[..., 1]
    h, w = y.shape
    hb, wb = h // BLOCK, w // BLOCK
    blocks = y[:hb * BLOCK, :wb * BLOCK].reshape(hb, BLOCK, wb, BLOCK)
    blocks = blocks.transpose(0, 2, 1, 3).reshape(hb, wb, -1)
    return blocks.mean(-1), blocks.var(-1), blocks.shape[-1]


def welch_t(img_a, img_b):
    ma, va, n = block_stats(img_a)
    mb, vb, _ = block_stats(img_b)
    denom = np.sqrt(np.maximum(va / n + vb / n, 1e-20))
    return (ma - mb) / denom


def main(argv=None):
    p = argparse.ArgumentParser(prog='welch')
    p.add_argument('a')
    p.add_argument('b')
    p.add_argument('--threshold', type=float, default=4.0,
                   help='|t| above which a block is flagged')
    args = p.parse_args(argv)
    t = welch_t(pfm.read_pfm(args.a), pfm.read_pfm(args.b))
    bad = int((np.abs(t) > args.threshold).sum())
    print(f'{bad}/{t.size} blocks significantly different '
          f'(max |t| = {np.abs(t).max():.2f})')
    return 0 if bad == 0 else 1


if __name__ == '__main__':
    sys.exit(main())
