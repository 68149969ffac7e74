"""The plain reference against the program on the CPU at 32x24, the
bfloat16 control, and the harness driven through a run with the timed
path broken underneath: each fault reads as not correct."""

import time

import numpy as np
import pytest
import torch

from portbench import compare, manifest, reference, run, scenes
from portbench.drivers import progressive

SIZE = (32, 24)
CELLS = ['0002_mb.progressive', '0031_hete.progressive']


def _sides(cell):
    c = manifest.cell(cell)
    keys = dict(c['config']['render'], width=SIZE[0], height=SIZE[1])
    build = lambda side: scenes.build(c['config']['scene'], side,
                                      manifest.ROOT, 'cpu', *SIZE)
    return c, keys, build(progressive.program_side()), build(reference.SIDE)


@pytest.mark.parametrize('cell', CELLS)
def test_reference_equals_program_on_cpu(cell):
    from corona13_tpu_torch import render
    from corona13_tpu_torch.samplers import pt
    c, keys, prog, ref = _sides(cell)
    for seed in (progressive.call_seed(2**31 + 9, 0), 12345):
        img = render.render(prog, pt.PTConfig(seed=seed, **keys), spp=1,
                            batch=1).fb
        want = reference.progression(ref, keys, seed)
        assert want.mean() > 0
        assert compare.pixels_off(img, want) == 0.0


@pytest.mark.parametrize('cell', CELLS)
def test_control_in_bfloat16_fails(cell):
    c, keys, _, ref = _sides(cell)
    limit = c['config']['limits']['pixels_off']
    for seed in (1, 2, 3):
        lowp = reference.progression(ref, keys, seed, lowp=True)
        assert compare.pixels_off(lowp, reference.progression(
            ref, keys, seed)) > 3 * limit


def test_pixels_off():
    ref = np.ones((4, 4, 3), np.float32)
    img = ref.copy()
    img[0, 0, 1] = 1.001
    img[1, 1, 2] = np.nan
    assert compare.pixels_off(img, ref) == 2 / 16
    assert compare.pixels_off(ref[:2], ref) == 1.0


def _unchanged_state(monkeypatch):
    from corona13_tpu_torch.samplers import pt
    monkeypatch.setattr(pt, '_bounce',
                        lambda scene, cfg, state, depth, u=None: state)


def _half_batch(monkeypatch):
    """Every other path left out, the rest counted twice (the mean kept)."""
    from corona13_tpu_torch.samplers import pt
    real = pt.sample_paths

    def half(scene, cfg, sample_idx, pixel_idx):
        accum, lam, pi, pj = real(scene, cfg, sample_idx, pixel_idx)
        keep = (pixel_idx % 2 == 0)[:, None]
        return torch.where(keep, 2.0 * accum, 0.0), lam, pi, pj
    monkeypatch.setattr(pt, 'sample_paths', half)


def _altered_answer(monkeypatch):
    """Each path's XYZ, where the splat gets it, off by one part in 1e3."""
    from corona13_tpu_torch.spectral import cie
    real = cie.spectral_to_xyz
    monkeypatch.setattr(cie, 'spectral_to_xyz',
                        lambda lam, acc: real(lam, acc) * 1.001)


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    r = run.run_cell(cell, 2**31 + 77, 0.3, False, device='cpu', size=SIZE,
                     t_start=time.perf_counter())
    assert r['correct'] and r['attempted'] >= 1
    want = {m['name'] for m in manifest.cell(cell)['end_to_end']}
    assert set(r['metrics']) == want and 'frame_s' in want
    assert list(r)[-1] == 'checks'


@pytest.mark.parametrize('fault', [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize('cell', CELLS)
def test_fault_reads_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run.run_cell(cell, 4242, 0.3, False, device='cpu', size=SIZE,
                     t_start=time.perf_counter())
    assert not r['correct']
    assert r['checks']['pixels_off']['value'] > \
        r['checks']['pixels_off']['limit']


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    rc = run.main(['--workload', '0002_mb.progressive', '--seed', '1',
                   '--seconds', '1'])
    assert rc != 0 and capsys.readouterr().out == ''
