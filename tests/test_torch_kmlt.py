"""pt's primary-sample replay and the port's kmlt against the JAX package.

The replay (``pt._sample_paths_full(u=...)``) on the same primary samples,
lane by lane: accum at rtol 1e-5 / atol 1e-6 and pix_i / pix_j at 1e-5 on
>= 99% of lanes, on cornell and on 0031_hete with media (measured: every
lane).  ``_mutate_dim`` elementwise (1e-6), ``_eval`` per chain (1e-5 on
>= 99% of chains, 1e-4 on all: XLA's fusion under jit moves a few ulp).
The chains of ``render_sample`` at 16x12 with chains=32, burn_in=2: the
seed indices of the stationary seeding and each step's accept mask
against the JAX package's own step run as a loop (``_jax_chains``;
measured: every chain, every step, bar 99%), and the frame (each pixel
within 1e-4 of the largest on >= 99% of pixels).  Port-only twins of
tests/test_kmlt.py (slow there): the mutation stays in [0, 1), replay
paths roam the film, kmlt ~ pt."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.ops import rng as jrng
from corona13_tpu.samplers import kmlt as jkmlt
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import testing
from corona13_tpu_torch.ops import rng as trng
from corona13_tpu_torch.samplers import kmlt
from corona13_tpu_torch.samplers import pt as pt_mod

J, T = jnp.asarray, torch.as_tensor
W, H = 16, 12
_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'data', 'golden', 'scenes')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers whose torch thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(js=None, w=W, h=H):
    js = jscene.fit_film(js or jtesting.cornell_scene(sphere='diffuse'), w, h)
    return js, convert.scene_from_numpy(js, device='cpu')


def _cfgs(**kw):
    kw = dict(dict(width=W, height=H, max_verts=4, mf=2), **kw)
    return jpt.PTConfig(**kw), pt_mod.PTConfig(**kw)


def _images_agree(got, want, share=0.99):
    """Each pixel within 1e-4 of the largest pixel, on >= share of the
    pixels."""
    top = float(np.abs(want).max())
    assert top > 0
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= share, close.mean()


def test_psd_dims_match_jax():
    assert (pt_mod.N_CAM_DIMS, pt_mod.N_BOUNCE_DIMS) == (jpt.N_CAM_DIMS,
                                                        jpt.N_BOUNCE_DIMS)
    for mv in (2, 4, 6, 8, 16):
        assert pt_mod.psd_dims(mv) == jpt.psd_dims(mv)


def _replay(js, ts, cfg_j, cfg_t, n, seed):
    u = np.random.default_rng(seed).uniform(
        0, 1, (n, jpt.psd_dims(cfg_j.max_verts))).astype(np.float32)
    zero = np.zeros(n, np.uint32)
    want = jax.jit(lambda u: jpt._sample_paths_full(
        js, cfg_j, jnp.uint32(0), J(zero), u=u)[:4])(J(u))
    tz = torch.zeros(n, dtype=torch.int64)
    got = pt_mod._sample_paths_full(ts, cfg_t, tz, tz, u=T(u))[:4]
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize('name', ['cornell', '0031_hete'])
def test_replay_matches_jax(name):
    """Every random decision read from u: accum, lam, pix_i, pix_j per
    lane; cornell with NEE, 0031_hete with media and NEE."""
    if name == 'cornell':
        js, ts = _pair()
        cfg_j, cfg_t = _cfgs(max_verts=6, mf=4)
    else:
        js, _ = jscene.load_scene(os.path.join(_SCENES, name, 'test.nra2'))
        js, ts = _pair(js)
        cfg_j, cfg_t = _cfgs(max_verts=6, mf=4, media=True)
    (aj, lj, pij, pjj), (at, lt, pit, pjt) = _replay(js, ts, cfg_j, cfg_t,
                                                     2048, 1)
    # XLA fuses the hero-wavelength rotation: an ulp apart
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    for got, want, size in ((pit, pij, W), (pjt, pjj, H)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert got.min() >= 0 and got.max() <= size
    close = np.isclose(at, aj, rtol=1e-5, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert (aj > 0).any(axis=-1).mean() > 0.05        # real signal


def test_replay_refuses_equiangular():
    js, ts = _pair()
    cfg_j, cfg_t = _cfgs(media=True, equiangular=True)
    d = jpt.psd_dims(4)
    with pytest.raises(ValueError) as want:
        jpt._sample_paths_full(js, cfg_j, jnp.uint32(0),
                               jnp.zeros(8, jnp.uint32), u=jnp.zeros((8, d)))
    with pytest.raises(ValueError) as got:
        tz = torch.zeros(8, dtype=torch.int64)
        pt_mod._sample_paths_full(ts, cfg_t, tz, tz, u=torch.zeros(8, d))
    assert str(got.value) == str(want.value)


def test_mutate_dim_matches_jax():
    g = np.random.default_rng(0)
    r, u1, u2 = g.uniform(0, 1, (3, 1 << 16)).astype(np.float32)
    r[:4] = [0.0, 1.0 - 2 ** -24, 0.999, 0.0005]
    want = np.asarray(jkmlt._mutate_dim(J(r), J(u1), J(u2)))
    got = kmlt._mutate_dim(T(r), T(u1), T(u2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (kmlt.S1, kmlt.S2, kmlt.P_LARGE_STEP) == (jkmlt.S1, jkmlt.S2,
                                                     jkmlt.P_LARGE_STEP)


def test_mutation_stays_in_unit_interval():
    """tests/test_kmlt.py::test_mutation_kernel_stays_in_unit_interval."""
    g = np.random.default_rng(1)
    r, u1, u2 = (T(g.uniform(0, 1, 4096).astype(np.float32))
                 for _ in range(3))
    r2 = kmlt._mutate_dim(r, u1, u2)
    assert (r2 >= 0).all() and (r2 < 1).all()
    d = torch.abs(r2 - r)
    d = torch.minimum(d, 1 - d)           # wraparound distance
    assert kmlt.S1 / 4 < float(d.median()) < kmlt.S2


def test_eval_matches_jax():
    js, ts = _pair()
    cfg_j, cfg_t = _cfgs()
    u = np.random.default_rng(3).uniform(0, 1, (1024, jpt.psd_dims(4))
                                         ).astype(np.float32)
    want = jax.jit(lambda u: jkmlt._eval(js, cfg_j, u))(J(u))
    got = kmlt._eval(ts, cfg_t, T(u))
    close = np.ones(1024, bool)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        c = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        close &= c.reshape(1024, -1).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert float(got[3].max()) > 0 and float((got[3] > 0).float().mean()) > 0.1


def test_replay_roams_the_film():
    """tests/test_kmlt.py::test_psd_replay_matches_layout: finite paths
    over the whole image."""
    ts = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2)
    u = torch.rand(1024, pt_mod.psd_dims(4),
                   generator=torch.Generator().manual_seed(3))
    pi, pj, xyz, i = kmlt._eval(ts, cfg, u)
    assert torch.isfinite(xyz).all()
    assert (pi >= 0).all() and (pi < 32).all() and (pj < 24).all()
    assert float(i.max()) > 0


def _jax_chains(js, cfg, sample_idx, chains, steps, mult, stuck_limit,
                propose):
    """The JAX package's chain dynamics (kmlt.py:80-150) as a loop: the
    seed indices and each step's accept mask.  propose(r0, u, fresh, u1,
    u2) -> u_t is the sampler's proposal."""
    d = jpt.psd_dims(cfg.max_verts)
    cid = jnp.arange(chains, dtype=jnp.uint32)
    base = jnp.uint32(sample_idx) * jnp.uint32(mult)
    ev = jax.jit(lambda u: jkmlt._eval(js, cfg, u)[3])
    u = jax.vmap(lambda k: jrng.uniform(cid, base, k + 100, cfg.seed),
                 out_axes=1)(jnp.arange(d))
    i = ev(u)
    cdf = jnp.cumsum(i)
    idx = jnp.clip(jnp.searchsorted(
        cdf, jrng.uniform(cid, base, 9999, cfg.seed) * cdf[-1]), 0,
        chains - 1)
    idx = jnp.where(cdf[-1] > 0.0, idx, cid.astype(idx.dtype))
    u, i = u[idx], i[idx]
    rejects = jnp.zeros((chains,), jnp.int32)
    accepts = []
    for it in range(1, steps + 1):
        b = base + jnp.uint32(it)
        draws = jax.vmap(lambda k: jrng.uniform(cid, b, k + 200, cfg.seed),
                         out_axes=1)(jnp.arange(3 * d))
        u_t = propose(jrng.uniform(cid, b, 0, cfg.seed), u, draws[:, :d],
                      draws[:, d:2 * d], draws[:, 2 * d:])
        i_t = ev(u_t)
        a = jnp.minimum(1.0, jnp.where(i > 0.0,
                                       i_t / jnp.maximum(i, 1e-30), 1.0))
        acc = (jrng.uniform(cid, b, 1, cfg.seed) < a) | \
            (rejects >= stuck_limit)
        rejects = jnp.where(acc, 0, rejects + 1)
        u = jnp.where(acc[:, None], u_t, u)
        i = jnp.where(acc, i_t, i)
        accepts.append(np.asarray(acc))
    return np.asarray(idx), np.stack(accepts)


def chains_agree(mod, jmod, sample_idx, propose, chains=32, burn_in=2):
    """The port's seeding and accept masks against ``_jax_chains``, and
    the frame of render_sample against the JAX package's (cornell at
    16x12); returns the share of chains whose whole accept sequence
    matched."""
    js, ts = _pair()
    cfg_j, cfg_t = _cfgs()
    steps = W * H // chains + burn_in
    idx_j, acc_j = _jax_chains(js, cfg_j, sample_idx, chains, steps,
                               mod.MULT, mod.STUCK_LIMIT, propose)
    carry = kmlt.init_chains(ts, cfg_t, sample_idx, chains, mod.MULT)
    # the seeded states are rows of one pool, picked by index
    pool = trng.uniform(torch.arange(chains)[:, None],
                        (sample_idx * mod.MULT) & trng.M32,
                        torch.arange(100, 100 + jpt.psd_dims(4))[None],
                        cfg_t.seed)
    seeded = (pool[T(idx_j.astype(np.int64))] == carry['u']).all(-1)
    assert float(seeded.float().mean()) >= 0.99, seeded.float().mean()
    acc_t = []
    for it in range(1, steps + 1):
        carry = mod.step(ts, cfg_t, carry, it, burn_in)
        acc_t.append((carry['rejects'] == 0).numpy())
    same = (np.stack(acc_t) == acc_j).all(axis=0)
    assert same.mean() >= 0.99, same.mean()
    assert 0 < acc_j.mean() < 1
    want = np.asarray(jax.jit(lambda s: jmod.render_sample(
        js, cfg_j, s, chains=chains, burn_in=burn_in))(jnp.uint32(
            sample_idx)))
    got = mod.render_sample(ts, cfg_t, sample_idx, chains=chains,
                            burn_in=burn_in).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    _images_agree(got, want)
    return same.mean()


def test_kmlt_matches_jax():
    """Chains seeded, accepted and splatted as in the JAX package (16x12,
    chains=32, burn_in=2, max_verts=4, sample index 5)."""
    def propose(r0, u, fresh, u1, u2):
        return jnp.where((r0 < jkmlt.P_LARGE_STEP)[:, None], fresh,
                         jkmlt._mutate_dim(u, u1, u2))
    assert chains_agree(kmlt, jkmlt, 5, propose) >= 0.99


def test_kmlt_matches_pt():
    """tests/test_kmlt.py::test_kmlt_matches_pt at its sizes and bounds."""
    cornell = testing.cornell_scene(sphere='diffuse', device='cpu')
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2,
                          use_nee=True)
    a = kmlt.render_sample(cornell, cfg, 0, batch=24, chains=512).numpy() / 24
    b = pt_mod.render_sample(cornell, cfg, 100, batch=32).numpy() / 32
    assert np.isfinite(a).all()
    ratio = a[..., 1].mean() / b[..., 1].mean()
    assert abs(ratio - 1.0) < 0.08, ratio
    corr = np.corrcoef(a[..., 1].ravel(), b[..., 1].ravel())[0, 1]
    assert corr > 0.5, corr
