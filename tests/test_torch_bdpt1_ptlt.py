"""The port's bdpt1 and ptlt against the JAX package: the strategy lists,
bdpt1's host table (picks and counts equal, means within 1e-5 relative
after 6 progressions), ptlt's image (each pixel within 1e-4 of the
largest on >= 99% of pixels), and twins of tests/test_bdpt1.py and
tests/test_ptlt.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.samplers import bdpt1 as jbdpt1
from corona13_tpu.samplers import pt as jpt
from corona13_tpu.samplers import ptlt as jptlt
from corona13_tpu_torch import convert
from corona13_tpu_torch.samplers import bdpt
from corona13_tpu_torch.samplers import bdpt1
from corona13_tpu_torch.samplers import pt as pt_mod
from corona13_tpu_torch.samplers import ptlt

W, H = 24, 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(w=W, h=H):
    js = jscene.fit_film(jtesting.cornell_scene(sphere='diffuse'), w, h)
    return js, convert.scene_from_numpy(js, device='cpu')


def _cfgs(**kw):
    kw = dict(dict(width=W, height=H, max_verts=4, mf=2, use_nee=True,
                   rr_start=99), **kw)
    return jpt.PTConfig(**kw), pt_mod.PTConfig(**kw)


@pytest.mark.parametrize('max_verts', [2, 3, 4, 6, 8])
def test_strategy_lists_match_jax(max_verts):
    cfg_j, cfg_t = _cfgs(max_verts=max_verts)
    assert bdpt1.strategies(cfg_t) == jbdpt1.strategies(cfg_j)
    assert ptlt.strategy_set(cfg_t) == jptlt.strategy_set(cfg_j)
    assert ptlt.strategy_set(cfg_t) <= set(bdpt1.strategies(cfg_t))


def test_config_table_matches_jax(monkeypatch):
    """Six progressions from a fresh table in both packages: the same
    strategy picked each time, the same counts, means within 1e-5.  The
    JAX bdpt1 calls its bdpt op by op; here that call is jitted once a
    strategy, as the other tests run it."""
    js, ts = _pair()
    cfg_j, cfg_t = _cfgs()
    real, jitted = jbdpt1.bdpt_mod.render_sample, {}

    def render(scene, cfg, sample_idx, batch=1, only=None):
        if only not in jitted:
            jitted[only] = jax.jit(lambda s: real(scene, cfg, s, batch=batch,
                                                  only=only))
        return jitted[only](sample_idx)
    monkeypatch.setattr(jbdpt1.bdpt_mod, 'render_sample', render)
    tj = jbdpt1.ConfigTable.create(cfg_j)
    tt = bdpt1.ConfigTable.create(cfg_t)
    assert tt.strategies == tj.strategies
    picks = []
    for s in range(6):
        idx, p = bdpt1.pick(cfg_t, s, tt)
        picks.append(idx)
        count = tj.count.copy()
        fb_j, tj = jbdpt1.render_sample(js, cfg_j, s, tj)
        fb_t, tt = bdpt1.render_sample(ts, cfg_t, s, tt)
        assert int(np.argmax(tj.count - count)) == idx     # the same pick
        np.testing.assert_array_equal(tt.count, tj.count)
        np.testing.assert_allclose(tt.mean, tj.mean, rtol=1e-5)
        np.testing.assert_allclose(tt.probs(), tj.probs(), rtol=1e-5)
        fb_j = np.asarray(fb_j)
        np.testing.assert_allclose(fb_t.numpy(), fb_j, rtol=0,
                                   atol=1e-4 * max(float(fb_j.max()), 1e-30))
    assert len(set(picks)) >= 3, picks
    assert tt.count.sum() == 6


def test_bdpt1_deterministic():
    """The pick rides the counter RNG keyed by the sample index and the
    splat sums in a fixed order: rerunning a progression reproduces the
    image bit for bit (tests/test_bdpt1.py::test_bdpt1_deterministic)."""
    ts = _pair()[1]
    cfg = _cfgs()[1]
    a, _ = bdpt1.render_sample(ts, cfg, 5, bdpt1.ConfigTable.create(cfg))
    b, _ = bdpt1.render_sample(ts, cfg, 5, bdpt1.ConfigTable.create(cfg))
    assert torch.equal(a, b)


def test_bdpt1_converges_to_bdpt():
    """tests/test_bdpt1.py::test_bdpt1_converges_to_bdpt."""
    ts = _pair()[1]
    cfg = _cfgs()[1]
    table = bdpt1.ConfigTable.create(cfg)
    acc = 0.0
    n = 24
    for s in range(n):
        fb, table = bdpt1.render_sample(ts, cfg, s, table)
        acc = acc + fb
    a = acc.numpy() / n
    b = sum(bdpt.render_sample(ts, cfg, s) for s in range(4)).numpy() / 4
    assert np.isfinite(a).all()
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.35, ratio
    assert table.count.sum() == n


def test_ptlt_matches_jax():
    js, ts = _pair(32, 18)
    cfg_j, cfg_t = _cfgs(width=32, height=18, max_verts=5)
    want = np.asarray(jax.jit(lambda s: jptlt.render_sample(js, cfg_j, s))(
        jnp.uint32(2)))
    got = ptlt.render_sample(ts, cfg_t, 2).numpy()
    assert got.shape == (18, 32, 3) and np.isfinite(got).all()
    top = float(want.max())
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()


def test_ptlt_lt_technique_alive():
    """The lt member of the family contributes (tests/test_ptlt.py::
    test_ptlt_lt_technique_alive)."""
    ts = _pair()[1]
    cfg = _cfgs()[1]
    strat = ptlt.strategy_set(cfg)
    full = t1 = 0.0
    for i in range(4):
        full = full + bdpt.render_sample(ts, cfg, i, strategies=strat).sum()
        for s in range(1, cfg.max_verts - 1):
            if (s, 1) in strat:
                t1 = t1 + bdpt.render_sample(ts, cfg, i, only=(s, 1),
                                             strategies=strat).sum()
    share = float(t1 / full)
    assert share > 0.02, share


def test_ptlt_matches_ptdl():
    """tests/test_ptlt.py::test_ptlt_matches_ptdl (ptlt's batch copies
    repeat, as bdpt's do, so its progressions are separate)."""
    sc = convert.scene_from_numpy(jtesting.cornell_scene(sphere='diffuse'),
                                  device='cpu')
    cfg = _cfgs(width=48, height=32, max_verts=5)[1]
    a = sum(ptlt.render_sample(sc, cfg, s) for s in range(3)).numpy() / 3
    b = sum(pt_mod.render_sample(sc, cfg, 16 * s, batch=16)
            for s in range(3)).numpy() / 48
    assert np.isfinite(a).all() and a[..., 1].mean() > 0.0
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.12, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.5, corr
