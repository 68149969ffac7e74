"""The port's skies against the JAX package: the image-based envmap
(models/envmap.py), the Preetham daylight sky (models/daylight.py), the
scene wiring of both, and the path tracer under them.

The same inputs, made from a numpy seed, go through the JAX function and
the port's; the JAX scene is carried over with its very tables by
``convert.scene_from_numpy(..., device='cpu')``.  Tolerances:

* envmap ``eval_radiance`` and ``pdf``: 1e-5 (relative to the table's
  largest value) on >= 99.5% of 4096 directions; ``atan2``, ``acos`` and
  ``%`` differ by an ulp between XLA and torch, which moves a direction on
  a texel border into the neighbouring texel;
* envmap ``sample``: the same row and column on >= 99.5% of lanes;
* daylight ``build`` tables 1e-6, ``eval_radiance`` 1e-4 relative;
* per-path ``accum`` equal (rtol 1e-4 / atol 1e-6) on >= 99% of paths.

Reference defects the port reproduces, each pinned here by name:
``test_daylight_defect_ozone_index`` (daylight.py:102),
``test_daylight_defect_horizon_cutoff`` (daylight.py:168) and
``test_daylight_defect_three_argument_line`` (scene.py:548).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.models import daylight as jdaylight
from corona13_tpu.models import envmap as jenvmap
from corona13_tpu.models import lights as jlights
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import testing
from corona13_tpu_torch.models import daylight, envmap, lights
from corona13_tpu_torch.samplers import pt as pt_mod

SUN = (0.3, 0.2, 0.9)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process (the suite runs in several xdist
    workers; see tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope='module')
def sun_env():
    """A 64x128 gradient sky with a sun disk: the JAX EnvMap and the same
    tables as the port's."""
    rgb = jenvmap.make_gradient_sky(sun_dir=(0.5, 0.3, 0.8), sun_radiance=40)
    je = jenvmap.build(rgb)
    return rgb, je, convert.scene_from_numpy(je, device='cpu')


# --- envmap -----------------------------------------------------------------

def test_envmap_build_matches_jax(sun_env):
    """The port's own build (its own Levenberg-Marquardt fit) against the
    JAX tables: CDFs and luminance to 1e-6, the fitted spectra to 1e-4."""
    rgb, je, _ = sun_env
    te = envmap.build(rgb, device='cpu')
    for k in ('mul', 'lum', 'row_cdf', 'col_cdf', 'total'):
        np.testing.assert_allclose(getattr(te, k).numpy(),
                                   np.asarray(getattr(je, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert te.total.shape == () and (te.height, te.width) == (64, 128)
    from corona13_tpu.spectral import rgb2spec as jr2s
    from corona13_tpu_torch.spectral import rgb2spec as tr2s
    lam = np.linspace(400, 700, 7).astype(np.float32)
    sj = np.asarray(jr2s.eval_coeff(je.coeff[:, :, None, :], jnp.asarray(lam)))
    st = tr2s.eval_coeff(te.coeff[:, :, None, :], torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-4)
    np.testing.assert_array_equal(
        envmap.make_gradient_sky(sun_dir=(0.5, 0.3, 0.8), sun_radiance=40),
        rgb)


def test_envmap_eval_and_pdf_match_jax(sun_env):
    _, je, te = sun_env
    d = _unit_dirs(4096, 0)
    lam = np.random.default_rng(1).uniform(400, 700, (4096, 4)).astype(
        np.float32)
    rj = np.asarray(jenvmap.eval_radiance(je, jnp.asarray(d), jnp.asarray(lam)))
    rt = envmap.eval_radiance(te, torch.as_tensor(d),
                              torch.as_tensor(lam)).numpy()
    ok = (np.abs(rt - rj) <= 1e-5 * max(rj.max(), 1.0)).all(axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    pj = np.asarray(jenvmap.pdf(je, jnp.asarray(d)))
    ptt = envmap.pdf(te, torch.as_tensor(d)).numpy()
    ok = np.abs(ptt - pj) <= 1e-5 * max(pj.max(), 1.0)
    assert ok.mean() >= 0.995, ok.mean()
    uj, vj = jenvmap._dir_to_uv(jnp.asarray(d))
    ut, vt = envmap._dir_to_uv(torch.as_tensor(d))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(
        envmap._uv_to_dir(ut, vt).numpy(),
        np.asarray(jenvmap._uv_to_dir(uj, vj)), atol=1e-6)


def test_envmap_sample_matches_jax(sun_env):
    """The bisection over each lane's own CDF row returns what JAX's
    vmapped searchsorted returns: the same texel centre."""
    _, je, te = sun_env
    g = np.random.default_rng(2)
    n = 1 << 14
    r1 = g.uniform(0, 1, n).astype(np.float32)
    r2 = g.uniform(0, 1, n).astype(np.float32)
    r2[:64] = 0.0                       # the searches' edges
    r2[64:128] = np.float32(1.0 - 2 ** -24)
    dj, pj = jenvmap.sample(je, jnp.asarray(r1), jnp.asarray(r2))
    dt, ptt = envmap.sample(te, torch.as_tensor(r1), torch.as_tensor(r2))
    same = (np.abs(dt.numpy() - np.asarray(dj)) < 1e-5).all(axis=-1)
    assert same.mean() >= 0.995, same.mean()
    close = np.abs(ptt.numpy() - np.asarray(pj)) <= 1e-5 * np.asarray(pj).max()
    assert close.mean() >= 0.995, close.mean()


def test_envmap_search_rows_is_searchsorted_left():
    """_search_rows against numpy's searchsorted(side='left') on every row,
    ties, zeros and a key above the row's last entry included."""
    g = np.random.default_rng(3)
    for w in (1, 2, 5, 64, 100):
        cdf = np.sort(g.integers(0, 12, (7, w)), axis=1).astype(np.float32) / 12
        row = g.integers(0, 7, 500)
        u = (g.integers(0, 14, 500) / 12).astype(np.float32)
        want = np.array([np.searchsorted(cdf[r], x, side='left')
                         for r, x in zip(row, u)])
        got = envmap._search_rows(torch.as_tensor(cdf), torch.as_tensor(row),
                                  torch.as_tensor(u)).numpy()
        np.testing.assert_array_equal(got, want)


def test_envmap_eval_constant():
    env = envmap.build(np.full((16, 32, 3), 0.7, np.float32), device='cpu')
    d = torch.as_tensor(_unit_dirs(256, 0))
    lam = torch.tensor([450.0, 550.0, 650.0, 600.0]).expand(256, 4)
    r = envmap.eval_radiance(env, d, lam).numpy()
    assert abs(r.mean() - 0.7) < 0.05
    assert r.std() < 0.1


def test_envmap_sample_pdf_consistency(sun_env):
    """E[g(d)] under importance sampling == the uniform-MC integral of
    g * pdf over the sphere (tests/test_envmap.py, on the port alone)."""
    _, _, env = sun_env
    n = 1 << 15
    r = np.random.default_rng(1)
    r1 = torch.as_tensor(r.uniform(0, 1, n).astype(np.float32))
    r2 = torch.as_tensor(r.uniform(0, 1, n).astype(np.float32))
    d, _ = envmap.sample(env, r1, r2)
    g = lambda dd: np.exp(dd[:, 2])
    est_s = g(d.numpy()).mean()
    du = r.normal(size=(n, 3)).astype(np.float32)
    du /= np.linalg.norm(du, axis=-1, keepdims=True)
    pu = envmap.pdf(env, torch.as_tensor(du)).numpy()
    est_u = (g(du) * pu).mean() * 4 * np.pi
    assert abs(est_s - est_u) / est_u < 0.05, (est_s, est_u)
    sd = np.asarray([0.5, 0.3, 0.8]) / np.linalg.norm([0.5, 0.3, 0.8])
    assert (d.numpy() @ sd > 0.995).mean() > 0.1


def test_constant_envmap_matches_const_sky():
    sc_const = testing.furnace_scene(albedo=0.5, emission=0.7, device='cpu')
    sc_env = sc_const.with_envmap(np.full((16, 32, 3), 0.7, np.float32))
    assert sc_env.has_envmap and int(sc_env.sky_kind) == tscene.SKY_ENVMAP
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2,
                          use_nee=False)
    a = render_mod.render(sc_const, cfg, spp=24).image_xyz
    b = render_mod.render(sc_env, cfg, spp=24).image_xyz
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05


def _sun_sky():
    return jenvmap.make_gradient_sky(top=(0.05, 0.05, 0.08),
                                     bottom=(0.02, 0.02, 0.02), sun_dir=SUN,
                                     sun_radiance=200.0)


def test_env_nee_matches_pt():
    """Sun-disk envmap: the NEE+MIS estimate equals the BSDF-only one on
    the sphere (tests/test_envmap.py, on the port alone)."""
    sc = testing.furnace_scene(albedo=0.6, emission=0.0,
                               device='cpu').with_envmap(_sun_sky())
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2)
    a = render_mod.render(sc, cfg, spp=64).image_xyz
    b = render_mod.render(sc, cfg.replace(use_nee=False), spp=256,
                          batch=128).image_xyz
    ya = a[8:16, 10:22, 1].mean()
    yb = b[8:16, 10:22, 1].mean()
    assert abs(ya - yb) / max(yb, 1e-9) < 0.12, (ya, yb)
    assert np.isfinite(a).all() and np.isfinite(b).all()


# --- daylight ---------------------------------------------------------------

def _dirs(thetas, phis):
    t = np.asarray(thetas)
    p = np.asarray(phis)
    return np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                     np.cos(t)], axis=-1).astype(np.float32)


@pytest.mark.parametrize('sun,turb', [((0.3, 0.2, 0.9), 2.5),
                                      ((0.5, 0.0, 0.4), 6.0),
                                      ((0.0, 0.0, 1.0), 2.0)])
def test_daylight_matches_jax(sun, turb):
    js = jdaylight.build(sun, turbidity=turb, mul=1.5)
    ts = daylight.build(sun, turbidity=turb, mul=1.5, device='cpu')
    for k in ('sun_dir', 'perez', 'zenith', 'theta_sun', 'sun_power', 'mul'):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    d = _unit_dirs(4096, 4)
    d[:8] = np.asarray(js.sun_dir)            # inside the sun disc
    lam = np.random.default_rng(5).uniform(380, 780, (4096, 4)).astype(
        np.float32)
    rj = np.asarray(jdaylight.eval_radiance(js, jnp.asarray(d),
                                            jnp.asarray(lam)))
    rt = daylight.eval_radiance(ts, torch.as_tensor(d),
                                torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-4 * rj.mean())
    assert rj[:8].max(axis=-1).min() > 50 * np.median(rj)


def test_daylight_basic_properties():
    sky = daylight.build([0.3, 0.2, 0.9], turbidity=2.5, device='cpu')
    lam = torch.tensor([450.0, 550.0, 600.0, 700.0]).expand(5, 4)
    d = torch.as_tensor(_dirs([0.1, 0.5, 1.0, 1.3, 1.5], [0, 1, 2, 3, 4]))
    rad = daylight.eval_radiance(sky, d, lam).numpy()
    assert np.isfinite(rad).all() and (rad >= 0).all() and rad.max() > 0
    # circumsolar brightening at equal elevation
    sun = sky.sun_dir.numpy()
    d2 = torch.as_tensor(np.stack([sun, sun * np.array([-1.0, -1.0, 1.0])])
                         .astype(np.float32))
    r2 = daylight.eval_radiance(sky, d2, torch.full((2, 4), 550.0)).numpy()
    assert r2[0].mean() > r2[1].mean()


def test_daylight_sun_disc():
    sky = daylight.build([0.0, 0.0, 1.0], turbidity=2.0, device='cpu')
    d = torch.tensor([[0.0, 0.0, 1.0], [np.sin(0.05), 0.0, np.cos(0.05)]],
                     dtype=torch.float32)
    r = daylight.eval_radiance(sky, d, torch.full((2, 2), 550.0)).numpy()
    assert r[0].mean() > 50 * r[1].mean()


def test_daylight_turbidity_reddens_horizon():
    d = torch.as_tensor(_dirs([1.45], [0.7]))
    lam = torch.tensor([[450.0, 700.0]])

    def ratio(t):
        sky = daylight.build([0.5, 0.0, 0.4], turbidity=t, device='cpu')
        r = daylight.eval_radiance(sky, d, lam).numpy()[0]
        return r[1] / max(r[0], 1e-9)

    assert ratio(6.0) > ratio(2.0)


def test_daylight_defect_ozone_index():
    """Reference defect (corona13_tpu/models/daylight.py:102), reproduced:
    K_O is tabulated from 450 nm but indexed from 380 nm, so the ozone
    absorption lands 70 nm too far to the blue.  The sun spectrum equals
    the JAX package's, not the one with the index put right."""
    ts = daylight.build(SUN, 2.5, device='cpu')
    np.testing.assert_allclose(
        ts.sun_power.numpy(), np.asarray(jdaylight.build(SUN, 2.5).sun_power),
        rtol=1e-6)
    theta = float(ts.theta_sun)
    m = 1.0 / (np.cos(theta) + 0.15 * (93.885 - np.degrees(theta)) ** -1.253)
    # at 380 nm the right index has no ozone term at all: the shipped
    # value is lower by exp(-K_O[0] * 0.35 * m)
    lam_um = 0.38
    tau = np.exp(-m * 0.008735 * lam_um ** -4.08) * np.exp(
        -m * (0.04608 * 2.5 + 0.04586) * lam_um ** -1.3)
    right = 400.0 / 2.5 ** 2 * tau * daylight.SUN_RAD[0] * 38.0 * 20.0
    got = float(ts.sun_power[0])
    assert got < right * (1 - 1e-4)
    np.testing.assert_allclose(got, right * np.exp(-daylight.K_O[0] * 0.35 * m),
                               rtol=1e-5)


def test_daylight_defect_horizon_cutoff():
    """Reference defect (daylight.py:168), reproduced: directions below
    the horizon down to z > -0.3 still get sky radiance."""
    ts = daylight.build(SUN, 2.5, device='cpu')
    d = torch.as_tensor(_dirs([np.arccos(-0.2), np.arccos(-0.4)], [0.3, 0.3]))
    r = daylight.eval_radiance(ts, d, torch.full((2, 2), 550.0)).numpy()
    assert r[0].min() > 0 and (r[1] == 0).all()


def _daylight_file(tmp_path, line):
    p = tmp_path / 'day.nra2'
    p.write_text(f'{line}\n1\ndiffuse # 0\n0\n')
    return str(p)


def test_daylight_scene_wiring(tmp_path):
    """`daylight <sundir> <turbidity>` parses into the same tables as the
    JAX loader's and escapes collect daylight radiance through sky_eval."""
    path = _daylight_file(tmp_path, 'daylight -0.3 -0.2 -0.8 3.0')
    ts, _ = tscene.load_scene(path, device='cpu')
    js, _ = jscene.load_scene(path)
    assert ts.has_daylight and not ts.has_envmap
    assert int(ts.sky_kind) == tscene.SKY_DAYLIGHT
    for k in ('sun_dir', 'perez', 'zenith', 'sun_power'):
        np.testing.assert_allclose(getattr(ts.daylight, k).numpy(),
                                   np.asarray(getattr(js.daylight, k)),
                                   rtol=1e-6, atol=1e-6)
    d = np.array([[0.3, 0.2, 0.8]], np.float32) / np.sqrt(0.77)
    r = lights.sky_eval(ts, torch.as_tensor(d), torch.full((1, 2), 550.0))
    rj = np.asarray(jlights.sky_eval(js, jnp.asarray(d), jnp.full((1, 2), 550.0)))
    assert np.isfinite(r.numpy()).all() and r.max() > 0
    np.testing.assert_allclose(r.numpy(), rj, rtol=1e-4)
    # the converted scene carries the tables too
    tc = convert.scene_from_numpy(js, device='cpu')
    assert tc.has_daylight
    np.testing.assert_array_equal(tc.daylight.perez.numpy(),
                                  np.asarray(js.daylight.perez))


def test_daylight_defect_three_argument_line(tmp_path):
    """Reference defect (corona13_tpu/scene.py:548), reproduced: a
    `daylight x y z` line without a turbidity drops the direction too and
    loads the default sun (1, 1, 1)/sqrt(3) at turbidity 2."""
    path = _daylight_file(tmp_path, 'daylight -0.3 -0.2 -0.8')
    ts, _ = tscene.load_scene(path, device='cpu')
    js, _ = jscene.load_scene(path)
    np.testing.assert_allclose(ts.daylight.sun_dir.numpy(),
                               np.full(3, 3 ** -0.5), rtol=1e-6)
    np.testing.assert_allclose(ts.daylight.sun_dir.numpy(),
                               np.asarray(js.daylight.sun_dir), rtol=1e-6)
    np.testing.assert_allclose(ts.daylight.perez.numpy(),
                               np.asarray(js.daylight.perez), rtol=1e-6)


# --- paths under a sky ------------------------------------------------------

W, H, SAMPLE = 32, 24, 2


def _paths_match(js, max_verts=4, **kw):
    js = jscene.fit_film(js, W, H)
    ts = convert.scene_from_numpy(js, device='cpu')
    cfg_j = jpt.PTConfig(width=W, height=H, max_verts=max_verts, mf=4, **kw)
    cfg_t = pt_mod.PTConfig(width=W, height=H, max_verts=max_verts, mf=4, **kw)
    pix = np.arange(W * H, dtype=np.uint32)
    smp = np.full(W * H, SAMPLE, np.uint32)

    def run(p, s):
        accum, *_, state = jpt._sample_paths_full(js, cfg_j, s, p)
        return accum, jnp.sum(state['nrays'])
    aj, rj = jax.jit(run)(jnp.asarray(pix), jnp.asarray(smp))
    tpix = torch.as_tensor(pix.astype(np.int64))
    tsmp = torch.as_tensor(smp.astype(np.int64))
    at, *_, state = pt_mod._sample_paths_full(ts, cfg_t, tsmp, tpix)
    aj, at = np.asarray(aj), at.numpy()
    close = np.isclose(at, aj, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert (aj > 0).any(axis=-1).mean() > 0.2          # real signal
    rt = int(state['nrays'].sum())
    assert abs(rt - int(rj)) <= 0.002 * int(rj), (rt, int(rj))
    return ts


@pytest.mark.parametrize('use_nee', [True, False])
def test_paths_match_jax_sun_envmap(use_nee):
    js = jtesting.furnace_scene(albedo=0.6, emission=0.0).with_envmap(
        _sun_sky())
    ts = _paths_match(js, use_nee=use_nee)
    assert ts.has_envmap and ts.envmap.col_cdf.shape == (64, 128)


def test_paths_match_jax_daylight():
    js = jtesting.furnace_scene(albedo=0.6, emission=0.0)
    js = js.replace(daylight=jdaylight.build(SUN, 2.5), has_daylight=True,
                    sky_kind=jnp.int32(jscene.SKY_DAYLIGHT))
    ts = _paths_match(js, use_nee=True)
    assert ts.has_daylight


def test_paths_match_jax_cornell_under_envmap():
    """Area-light NEE and envmap NEE in one bounce: two shadow rays."""
    js = jtesting.cornell_scene(sphere='diffuse').with_envmap(_sun_sky())
    _paths_match(js, use_nee=True)
