"""Wavefront compaction (cfg.compact) in the port: against the JAX package
per path, and the three cases of tests/test_compact.py on the port alone.

With the bit-exact counter RNG and a stable sort the same lanes survive a
capacity overflow as in JAX, so the compacted paths are held per path (>=
99% equal at rtol 1e-4 / atol 1e-6, like the dense ones), not only by
energy.  With capacities 1.0 compaction is a permutation and a re-bank: the
image equals the dense one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch import testing
from corona13_tpu_torch.samplers import pt as pt_mod

W, H = 32, 24
CAPS = (1.0, 0.8, 0.7, 0.6)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def cornell():
    return testing.cornell_scene(sphere='diffuse', device='cpu')


CFG = pt_mod.PTConfig(width=W, height=H, max_verts=5, mf=2, use_nee=True)


@pytest.mark.parametrize('caps', [CAPS, (1.0, 0.5, 0.5, 0.25)])
def test_compacted_paths_match_jax(caps):
    """The same survivors: per-path accum and the traced-ray count of the
    capped wavefront against JAX's."""
    js = jscene.fit_film(jtesting.cornell_scene(sphere='diffuse'), W, H)
    ts = convert.scene_from_numpy(js, device='cpu')
    cfg_j = jpt.PTConfig(width=W, height=H, max_verts=5, mf=2, use_nee=True,
                         compact=caps)
    cfg_t = CFG.replace(compact=caps)
    pix = np.arange(W * H, dtype=np.uint32)
    for sample in (0, 3):
        smp = np.full(W * H, sample, np.uint32)

        def run(p, s):
            accum, *_, state = jpt._sample_paths_full(js, cfg_j, s, p)
            return accum, jnp.sum(state['nrays'])
        aj, rj = jax.jit(run)(jnp.asarray(pix), jnp.asarray(smp))
        at, *_, state = pt_mod._sample_paths_full(
            ts, cfg_t, torch.as_tensor(smp.astype(np.int64)),
            torch.as_tensor(pix.astype(np.int64)))
        aj, at = np.asarray(aj), at.numpy()
        close = np.isclose(at, aj, rtol=1e-4, atol=1e-6).all(axis=-1)
        assert close.mean() >= 0.99, (sample, close.mean())
        assert (aj > 0).any(axis=-1).mean() > 0.5
        rt = int(state['nrays'].sum())
        assert abs(rt - int(rj)) <= 0.002 * int(rj), (rt, int(rj))
        # capping dropped alive lanes: fewer rays than the dense wavefront
        dense = int(pt_mod.count_rays(
            ts, CFG, sample, torch.as_tensor(pix.astype(np.int64))))
        assert rt < dense


def test_capacities_rounding():
    """cap_n as in the JAX package: round(c * n) up to a multiple of 128,
    at least 128, at most n; a malformed schedule raises."""
    cfg = CFG.replace(compact=CAPS)
    assert pt_mod.capacities(cfg, 768) == [768, 640, 640, 512]
    assert pt_mod.capacities(cfg.replace(compact=(1.0, 0.01, 0.0, 0.0)),
                             768) == [768, 128, 128, 128]
    assert pt_mod.capacities(cfg, 100) == [100, 100, 100, 100]
    for bad in ((1.0, 0.5), (0.9, 0.8, 0.7, 0.6)):
        with pytest.raises(ValueError):
            pt_mod.capacities(cfg.replace(compact=bad), 768)


def test_compact_identity_matches_dense(cornell):
    a = pt_mod.render_sample(cornell, CFG, 0).numpy()
    b = pt_mod.render_sample(cornell, CFG.replace(compact=(1.0,) * 4),
                             0).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert a.mean() > 0


def test_compact_shrinks_to_dead_lanes():
    """Capacities above the alive share: the wavefront shrinks, every path
    keeps its radiance (sorting and banking lose nothing), and batched
    progressions go through the same loop."""
    sc = testing.furnace_scene(albedo=0.5, emission=1.0, device='cpu')
    cfg = pt_mod.PTConfig(width=W, height=H, max_verts=5, mf=2)
    prof = pt_mod.alive_profile(sc, cfg, 1).numpy() / (W * H)
    assert prof[1] < 0.6                     # most camera rays escape
    caps = (1.0,) + tuple(float(min(1.0, p * 1.2 + 0.02)) for p in prof[1:])
    pix = torch.arange(W * H)
    a = pt_mod.sample_paths(sc, cfg, 1, pix)[0].numpy()
    b = pt_mod.sample_paths(sc, cfg.replace(compact=caps), 1, pix)[0].numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert int(pt_mod.count_rays(sc, cfg, 1, pix)) == int(
        pt_mod.count_rays(sc, cfg.replace(compact=caps), 1, pix))
    fa = pt_mod.render_sample(sc, cfg, 0, batch=2).numpy()
    fb = pt_mod.render_sample(sc, cfg.replace(compact=caps), 0,
                              batch=2).numpy()
    np.testing.assert_allclose(fa, fb, rtol=1e-5, atol=1e-6)


def test_compact_capping_unbiased(cornell):
    """Aggressive caps force stochastic capping at every depth (cornell
    paths rarely die); the alive / capacity reweight preserves energy."""
    cfg_c = CFG.replace(compact=CAPS)
    a = b = 0.0
    for s in range(4):
        a = a + pt_mod.render_sample(cornell, CFG, s).numpy()
        b = b + pt_mod.render_sample(cornell, cfg_c, s).numpy()
    ratio = b.mean() / a.mean()
    assert abs(ratio - 1.0) < 0.05, ratio


def test_alive_profile(cornell):
    """alive_profile ignores cfg.compact (it profiles the dense wavefront)
    and render.render takes a compacted config."""
    prof = pt_mod.alive_profile(cornell, CFG.replace(compact=CAPS), 0).numpy()
    n = W * H
    assert prof.shape == (CFG.max_verts - 1,)
    assert prof[0] == n                    # all camera rays alive
    assert np.all(np.diff(prof) <= 0)      # monotone non-increasing
    res = render_mod.render(cornell, CFG.replace(compact=CAPS), spp=2,
                            path_hist=True)
    assert np.isfinite(res.image_xyz).all() and res.image_xyz.mean() > 0
    np.testing.assert_array_equal(res.path_hist, prof)
