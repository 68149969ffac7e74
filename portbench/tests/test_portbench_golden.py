"""The plain reference against corona-13's own renders of the benchmark's
scenes (``data/golden/*.pfm``, 2048 samples a pixel at 256x160): the one
check of the reference's semantics that owes nothing to the port it was
copied from.  Sizes, depths, samples and bars are those of the
repository's golden gates (``tests/test_golden.py``), on the CPU."""

import os

import numpy as np
import pytest
import torch

from portbench import manifest, reference, scenes
from portbench.reference.tracer.io import pfm

GOLDEN = os.path.join(manifest.ROOT, 'data', 'golden')

# scene: (width, height, max_verts, mf, spp, batch, downsampling of the
# golden, RMSE bar, bar on the relative error of the mean)
GATES = {'0002_mb': (128, 80, 6, 4, 24, 8, 2, 0.35, 0.05),
         '0031_hete': (64, 40, 12, 2, 16, 8, 4, 0.06, 0.12)}


def _down(img, f):
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


@pytest.mark.parametrize('name', sorted(GATES))
def test_reference_matches_corona13(name):
    w, h, verts, mf, spp, batch, down, bar, mean_bar = GATES[name]
    torch.set_num_threads(4)
    spec = {'kind': 'nra2',
            'path': f'data/golden/scenes/{name}/test.nra2'}
    sc = scenes.build(spec, reference.SIDE, manifest.ROOT, 'cpu', w, h)
    keys = dict(width=w, height=h, max_verts=verts, mf=mf, use_nee=True)
    fb = reference.progression(sc, keys, 0, spp, batch)
    img = fb * float(sc.camera.iso) / (100.0 * spp)
    gold = _down(pfm.read_pfm(os.path.join(GOLDEN, f'{name}.pfm')), down)
    rmse = pfm.rmse(img, gold)
    mean_rel = abs(img.mean() - gold.mean()) / gold.mean()
    print(f'{name}: RMSE {rmse:.5f} (bar {bar}), mean off by '
          f'{mean_rel:.4f} (bar {mean_bar})')
    assert np.isfinite(img).all()
    assert rmse < bar and mean_rel < mean_bar
