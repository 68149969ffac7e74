"""The port's progressive photon mapping against the JAX package.

``photon_pass`` record by record on cornell with the dielectric sphere at
16x12 (``valid`` equal; positions, directions and powers within 1e-4 on
>= 99% of the records and within 1e-5 on >= 98%; measured: 100% and
98.8%, the rest a few hundred ulp apart in power after a bounce or two,
as the per-path bar of tests/test_torch_render.py).  ``build_grid`` fed
the JAX
package's photons: sorted cell ids equal, the capped records within 1e-6,
and a cell of 40 photons keeps its first 16 by path index at 40/16 of
their power.  ``gather`` at given points within 1e-5 relative of the
largest estimate.  ``render_sample`` at 16x12, max_verts=3 (the eye walk
gathers at depth 0 or, through the sphere, at depth 1) for sample indices
0 and 9 (each pixel within 1e-4 of the largest on >= 99% of pixels; measured:
all).  Port-only twins of tests/test_ppm.py (slow there): ppm ~ pt, the
radius shrinks.  Reference defects, pinned: batch copies trace the same
eye paths, and the photon pass and the eye walk ignore the shutter
time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.samplers import ppm as jppm
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import testing
from corona13_tpu_torch.samplers import ppm
from corona13_tpu_torch.samplers import pt as pt_mod

J, T = jnp.asarray, torch.as_tensor
W, H = 16, 12


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def pair():
    js = jscene.fit_film(jtesting.cornell_scene(sphere='dielectric'), W, H)
    kw = dict(width=W, height=H, max_verts=3, mf=2)
    return (js, convert.scene_from_numpy(js, device='cpu'),
            jpt.PTConfig(**kw), pt_mod.PTConfig(**kw))


@pytest.fixture(scope='module')
def jax_photons(pair):
    js, _, cfg_j, _ = pair
    ph = jax.jit(lambda s: jppm.photon_pass(js, cfg_j, s, 2 * W * H, 3))(
        jnp.uint32(4))
    return {k: np.asarray(v) for k, v in ph.items()}


def _images_agree(got, want, share=0.99):
    top = float(np.abs(want).max())
    assert top > 0
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= share, close.mean()


def test_constants_match_jax():
    assert (ppm.ALPHA, ppm.K_PER_CELL, ppm.GRID) == (jppm.ALPHA,
                                                     jppm.K_PER_CELL,
                                                     jppm.GRID)


def test_photon_pass_matches_jax(pair, jax_photons):
    _, ts, _, cfg_t = pair
    got = {k: v.numpy() for k, v in
           ppm.photon_pass(ts, cfg_t, 4, 2 * W * H, 3).items()}
    want = jax_photons
    assert set(got) == set(want) and got['pos'].shape == (3 * 2 * W * H, 3)
    np.testing.assert_array_equal(got['valid'], want['valid'])
    # XLA fuses the hero-wavelength rotation: an ulp apart
    np.testing.assert_allclose(got['lam'], want['lam'], rtol=1e-6)
    valid = want['valid']
    assert 0.2 < valid.mean() < 0.9
    for tol, share in ((1e-4, 0.99), (1e-5, 0.98)):
        close = np.ones(valid.sum(), bool)
        for k in ('pos', 'wi', 'power'):
            close &= np.isclose(got[k][valid], want[k][valid], rtol=tol,
                                atol=tol).all(axis=-1)
        assert close.mean() >= share, (tol, close.mean())


def test_build_grid_matches_jax(jax_photons):
    ph = dict(jax_photons)
    # a dense cell outside the box (no other photon there): 40 valid
    # photons of powers 1..40, spread over the path order
    dense = np.arange(5, 5 + 40 * 7, 7)
    spot = np.float32([30.1, 30.3, 30.7])
    ph['pos'] = ph['pos'].copy()
    ph['pos'][dense] = spot
    ph['valid'] = ph['valid'].copy()
    ph['valid'][dense] = True
    ph['power'] = ph['power'].copy()
    ph['power'][dense] = np.arange(1, 41, dtype=np.float32)[:, None]
    lo, cell = np.float32([-6.0, -6.0, 9.0]), np.float32(0.4)
    want_j, cid_j = jppm.build_grid({k: J(v) for k, v in ph.items()}, J(lo),
                                    J(cell))
    got, cid_t = ppm.build_grid({k: T(v) for k, v in ph.items()}, T(lo),
                                T(cell))
    got, cid_t = got.numpy(), cid_t.numpy()
    np.testing.assert_array_equal(cid_t, np.asarray(cid_j))
    assert (cid_t == ppm.GRID ** 3).sum() == (~ph['valid']).sum()
    want = np.concatenate([np.asarray(want_j[k]) for k in
                           ('pos', 'wi', 'lam', 'power')], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the dense cell's run: its first 16 by path index, scaled by 40/16
    g = np.floor((spot - lo) / cell).astype(np.int64)
    run = got[cid_t == g[0] + ppm.GRID * (g[1] + ppm.GRID * g[2])]
    mf = ph['lam'].shape[1]
    assert len(run) == 40
    np.testing.assert_allclose(run[:16, 6 + mf], np.arange(1, 17) * 2.5,
                               rtol=1e-6)
    assert (run[16:, 6 + mf:] == 0).all()


def test_gather_matches_jax(pair, jax_photons):
    js, ts, _, _ = pair
    ph = jax_photons
    r = np.float32(0.6)
    lo = np.asarray(js.geom.tri_bvh.nodes[0][0:3])
    cell = np.float32(2.0) * r
    sorted_j, cid_j = jppm.build_grid({k: J(v) for k, v in ph.items()},
                                      J(lo), J(cell))
    recs, cid_t = ppm.build_grid({k: T(v) for k, v in ph.items()}, T(lo),
                                 T(cell))
    # gather points: jittered photon positions, with their normals
    g = np.random.default_rng(5)
    valid = np.flatnonzero(ph['valid'])
    pick = g.choice(valid, 512)
    x = (ph['pos'][pick] + g.normal(0, 0.05, (512, 3))).astype(np.float32)
    x[:64] = g.uniform(-1e4, 1e4, (64, 3))   # far from every cell
    nrm = -ph['wi'][pick] + g.normal(0, 0.2, (512, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    mat = g.integers(0, int(js.materials.kind.shape[0]), 512)
    want = np.asarray(jax.jit(lambda x, n, m: jppm.gather(
        js, sorted_j, cid_j, x, n, m, J(r), J(lo), J(cell), 777))(
        J(x), J(nrm), J(mat.astype(np.int32))))
    got = ppm.gather(ts, recs, cid_t, T(x), T(nrm), T(mat), T(r), T(lo),
                     T(cell), 777).numpy()
    assert (want[64:] > 0).any(axis=-1).mean() > 0.3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope='module')
def jax_frames(pair):
    js, _, cfg_j, _ = pair
    f = jax.jit(lambda s: jppm.render_sample(js, cfg_j, s))
    return {s: np.asarray(f(jnp.uint32(s))) for s in (0, 9)}


@pytest.mark.parametrize('s', [0, 9])
def test_ppm_matches_jax(pair, jax_frames, s):
    _, ts, _, cfg_t = pair
    got = ppm.render_sample(ts, cfg_t, s).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    _images_agree(got, jax_frames[s])


def test_ppm_matches_pt():
    """tests/test_ppm.py::test_ppm_matches_pt at its sizes and bounds."""
    cornell = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=48, height=32, max_verts=5, mf=2,
                          use_nee=True, rr_start=99)
    a = sum(ppm.render_sample(cornell, cfg, s) for s in range(4)).numpy() / 4
    b = sum(pt_mod.render_sample(cornell, cfg, s, batch=8)
            for s in range(3)).numpy() / 24
    assert np.isfinite(a).all() and a[..., 1].mean() > 0
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.3, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.5, corr


def test_ppm_radius_shrinks(pair):
    """tests/test_ppm.py::test_ppm_radius_shrinks: later progressions
    gather over a smaller radius, r_i = 0.025 ext (i+1)^((alpha-1)/2)."""
    _, ts, _, cfg_t = pair
    radii = []
    real = ppm.gather

    def spy(scene, recs, cid_s, x, n_gather, mat, r, *a):
        radii.append(float(r))
        return real(scene, recs, cid_s, x, n_gather, mat, r, *a)
    ppm.gather = spy
    try:
        frames = [ppm.render_sample(ts, cfg_t, s).numpy() for s in (0, 9)]
    finally:
        ppm.gather = real
    assert all(np.isfinite(f).all() for f in frames)
    r0, r9 = radii[0], radii[-1]
    assert r9 < r0
    np.testing.assert_allclose(r9 / r0, 10 ** ((ppm.ALPHA - 1) / 2),
                               rtol=1e-5)


def test_ppm_batch_copies_repeat_reference_defect(pair):
    """Reference defect, reproduced: ppm.py:204-205 tiles the pixel ids
    over ``batch`` with one sample index, so the batch copies trace the
    same eye paths against the same photons: a batch of 2 is twice a
    batch of 1, bit for bit (as bdpt's, tests/test_torch_bdpt.py)."""
    _, ts, _, cfg_t = pair
    one = ppm.render_sample(ts, cfg_t, 2)
    assert torch.equal(ppm.render_sample(ts, cfg_t, 2, batch=2), one + one)


def test_ppm_ignores_shutter_time_reference_defect(pair):
    """Reference defect, reproduced: ppm.py:77-78 and :250-251 call
    ``intersect`` without ``time``, so on a moving scene (the cornell
    sphere displaced over a wide-open shutter) the photons and the eye
    rays see the geometry at shutter open: the JAX package's photons and
    the port's frame equal those of the scene held still."""
    js, _, cfg_j, cfg_t = pair
    still = js.replace(camera=js.camera.replace(
        exposure_time=jnp.float32(1.0)))
    moving = still.replace(geom=still.geom.replace(
        sph_c_t1=still.geom.sph_c + J([[4.0, 0.0, 0.0]]), has_motion=True))
    a, b = (jax.jit(lambda s: jppm.photon_pass(sc, cfg_j, s, 256, 2))(
        jnp.uint32(1)) for sc in (moving, still))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    ts_still = convert.scene_from_numpy(still, device='cpu')
    ts_mb = convert.scene_from_numpy(moving, device='cpu')
    assert ts_mb.geom.has_motion
    assert torch.equal(ppm.render_sample(ts_mb, cfg_t, 1),
                       ppm.render_sample(ts_still, cfg_t, 1))
    assert not torch.equal(pt_mod.render_sample(ts_mb, cfg_t, 1),
                           pt_mod.render_sample(ts_still, cfg_t, 1))
