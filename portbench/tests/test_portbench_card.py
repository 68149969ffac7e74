"""On the card: a short run of each cell is correct and reports its
metrics.  Marked ``gpu``; skipped without a card (decided in the test).
On the card: ``python -m pytest portbench/tests -q -m gpu``."""

import time

import pytest
import torch

from portbench import run

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize('cell', ['0002_mb.progressive',
                                  '0031_hete.progressive'])
@pytest.mark.parametrize('traced', [False, True])
def test_cell_on_card(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    r = run.run_cell(cell, 2**31 + 123, 2.0, traced,
                     t_start=time.perf_counter())
    assert r['correct'], r['checks']
    assert r['device']['platform'] == 'gpu' and r['device']['count'] == 1
    if traced:
        assert 0 < r['device']['busy_s'] <= r['device']['window_s']
        assert {'launches_per_frame', 'idle_share', 'trace_ms',
                'trace_roofline'} <= set(r['metrics'])
        assert 0 < r['metrics']['trace_roofline']['value'] <= 100
    else:
        assert r['metrics']['frame_s']['value'] > 0
