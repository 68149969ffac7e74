"""The port's path tracer against the JAX package, and the render
properties of tests/test_render.py re-run on the port.

Per-path comparison: both packages trace the same scene (converted from
the JAX one) at the same sample index.  >= 99% of paths must agree at
rtol 1e-4 / atol 1e-6 over up to five bounces of float32 shading; the
rest are branch flips from float32 near-ties (Russian-roulette
thresholds, and rays through a quad's diagonal, where the JAX package's
CPU traversal keeps the later of two equal hits and the kernel the
first).  Image means within 0.5% and traced-ray counts within 0.1%.
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
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import testing, tracing
from corona13_tpu_torch.samplers import pt as pt_mod

W, H = 32, 18
SAMPLE = 3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers, whose torch thread pools would oversubscribe the cores (up to
    50x slower here), and these small wavefronts gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(js, max_verts, use_nee):
    js = jscene.fit_film(js, W, H)
    ts = convert.scene_from_numpy(js, device='cpu')
    cfg_j = jpt.PTConfig(width=W, height=H, max_verts=max_verts, mf=4,
                         use_nee=use_nee)
    cfg_t = pt_mod.PTConfig(width=W, height=H, max_verts=max_verts, mf=4,
                            use_nee=use_nee)
    n = W * H
    pix = np.arange(n, dtype=np.uint32)
    smp = np.full(n, SAMPLE, np.uint32)
    aj, lj, ij, jj = jax.jit(lambda p, s: jpt.sample_paths(js, cfg_j, s, p))(
        jnp.asarray(pix), jnp.asarray(smp))
    tpix = torch.as_tensor(pix.astype(np.int64))
    tsmp = torch.as_tensor(smp.astype(np.int64))
    at, lt, it, jt = pt_mod.sample_paths(ts, cfg_t, tsmp, tpix)
    aj, at = np.asarray(aj), at.numpy()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6)
    close = np.isclose(at, aj, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert (aj > 0).any(axis=-1).mean() > 0.02         # real signal
    # images: the same splat of both packages' paths
    img_j = np.asarray(jax.jit(lambda s: jpt.render_sample(js, cfg_j, s))(
        jnp.uint32(SAMPLE)))
    img_t = pt_mod.render_sample(ts, cfg_t, SAMPLE).numpy()
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * img_j.mean()
    rj = int(jpt.count_rays(js, cfg_j, jnp.asarray(smp), jnp.asarray(pix)))
    rt = int(pt_mod.count_rays(ts, cfg_t, tsmp, tpix))
    assert abs(rt - rj) <= 0.001 * rj, (rt, rj)


@pytest.mark.parametrize('use_nee', [True, False])
def test_paths_match_jax_cornell(use_nee):
    _compare(jtesting.cornell_scene(sphere='diffuse'), 6, use_nee)


@pytest.mark.parametrize('sphere', ['dielectric', 'metal'])
def test_paths_match_jax_cornell_specular(sphere):
    _compare(jtesting.cornell_scene(sphere=sphere), 6, True)


def test_paths_match_jax_plane_scene():
    """The 8198-triangle scene (plane.geo + emitter.geo, 0002_mb camera)."""
    _compare(jtesting.assemble_scene(*testing.plane_scene_inputs()), 3, True)


@pytest.fixture(scope='module')
def cornell():
    return testing.cornell_scene(sphere='diffuse', device='cpu')


def _render(scene, spp=4, w=64, h=48, **kw):
    cfg = pt_mod.PTConfig(width=w, height=h, max_verts=kw.pop('max_verts', 5),
                          mf=4, **kw)
    return render_mod.render(scene, cfg, spp=spp)


def test_cornell_smoke(cornell, tmp_path):
    before = dict(tracing.launches)
    res = _render(cornell, spp=4)
    img = res.image_xyz
    assert np.isfinite(img).all()
    assert img.max() > 0
    assert img.min() >= 0
    assert (img.sum(axis=-1) > 0).mean() > 0.9
    assert tracing.launches == before     # the CPU takes the plain walk
    srgb = res.image_srgb
    assert srgb.shape == img.shape and np.isfinite(srgb).all()
    res.write_pfm(str(tmp_path / 'r.pfm'))
    from corona13_tpu.io import pfm as pfm_io
    np.testing.assert_allclose(pfm_io.read_pfm(str(tmp_path / 'r.pfm')), img,
                               rtol=1e-6)
    res.path_hist = np.array([10, 8, 4, 1])
    res.write_sidecar(str(tmp_path / 'r.txt'), extra={'scene': 'cornell'})
    text = (tmp_path / 'r.txt').read_text()
    assert 'spp      : 4' in text and 'pathlen' in text


def test_pt_vs_ptdl_agree(cornell):
    """PT and PTDL estimate the same integral: means within 8% (MC noise
    at these sample counts, as in tests/test_render.py)."""
    cfg_pt = pt_mod.PTConfig(width=48, height=32, max_verts=4, mf=4,
                             use_nee=False)
    cfg_dl = pt_mod.PTConfig(width=48, height=32, max_verts=4, mf=4,
                             use_nee=True)
    a = render_mod.render(cornell, cfg_pt, spp=96, batch=96).image_xyz
    b = render_mod.render(cornell, cfg_dl, spp=32, batch=32).image_xyz
    ma, mb = a.mean(), b.mean()
    assert abs(ma - mb) / max(mb, 1e-9) < 0.08, (ma, mb)


def test_furnace():
    """An albedo-1 diffuse sphere under a constant sky matches the sky
    within 3%; albedo 0.5 gives half (same pixels, as in test_render.py)."""
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=4,
                          use_nee=False, rr_start=99)
    with_s = testing.furnace_scene(albedo=1.0, emission=1.0, device='cpu')
    no_s = testing.furnace_scene(albedo=1.0, emission=1.0, sphere=False,
                                 device='cpu')
    a = render_mod.render(with_s, cfg, spp=32).image_xyz[..., 1]
    b = render_mod.render(no_s, cfg, spp=32).image_xyz[..., 1]
    center_a = a[10:14, 14:18].mean()
    center_b = b[10:14, 14:18].mean()
    assert center_b > 0
    assert abs(center_a - center_b) / center_b < 0.03, (center_a, center_b)
    half = testing.furnace_scene(albedo=0.5, emission=1.0, device='cpu')
    c = render_mod.render(half, cfg, spp=32).image_xyz[..., 1]
    center_c = c[10:14, 14:18].mean()
    assert abs(center_c - 0.5 * center_b) / center_b < 0.03, (center_c, center_b)


def test_mf_lanes_consistent(cornell):
    """MF=1 and MF=4 estimate the same image (hero MIS), within 10%."""
    cfg1 = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=1)
    cfg4 = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=4)
    a = render_mod.render(cornell, cfg1, spp=64, batch=64).image_xyz
    b = render_mod.render(cornell, cfg4, spp=16, batch=16).image_xyz
    assert abs(a.mean() - b.mean()) / b.mean() < 0.1


def test_determinism(cornell):
    cfg = pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=4)
    a = render_mod.render(cornell, cfg, spp=2).fb
    b = render_mod.render(cornell, cfg, spp=2).fb
    np.testing.assert_array_equal(a, b)


def test_alive_profile_and_fit_film(cornell):
    cfg = pt_mod.PTConfig(width=16, height=9, max_verts=5, mf=4)
    prof = pt_mod.alive_profile(cornell, cfg, 0).numpy()
    assert prof[0] == 16 * 9 and (np.diff(prof) <= 0).all()
    res = render_mod.render(cornell, cfg, spp=1, path_hist=True)
    np.testing.assert_array_equal(res.path_hist, prof)
    fitted = tscene.fit_film(cornell, 1024, 576)
    js = jscene.fit_film(jtesting.cornell_scene(), 1024, 576)
    np.testing.assert_allclose(fitted.camera.film_height.numpy(),
                               np.asarray(js.camera.film_height), rtol=1e-7)


def test_unported_configs_raise(cornell):
    """What used to raise NotImplementedError now traces: cfg.compact, a
    daylight sky and an envmap sky give finite paths with signal; only a
    malformed capacity schedule raises.  Image textures: a scene that
    carries an atlas none of its materials uses traces the paths of the
    scene without it."""
    import dataclasses
    from corona13_tpu_torch.models import daylight
    n = 16
    pix = torch.arange(n)
    cfg = pt_mod.PTConfig(width=4, height=4, max_verts=3)
    sky = dataclasses.replace(
        cornell, has_daylight=True,
        daylight=daylight.build((0.3, 0.2, 0.9), 2.5, device='cpu'))
    env = cornell.with_envmap(np.full((4, 8, 3), 0.5, np.float32))
    for sc, c in ((cornell, cfg.replace(compact=(1.0, 0.5))), (sky, cfg),
                  (env, cfg)):
        accum = pt_mod.sample_paths(sc, c, 0, pix)[0]
        assert torch.isfinite(accum).all() and accum.sum() > 0
    with pytest.raises(ValueError):
        pt_mod.sample_paths(cornell, cfg.replace(compact=(1.0,)), 0, pix)
    textured = dataclasses.replace(
        cornell, has_textures=True, tex_atlas=torch.zeros(1, 2, 2, 4),
        tex_dims=torch.tensor([[2, 2]]))
    plain = pt_mod.sample_paths(cornell, cfg, 0, pix)[0]
    assert plain.sum() > 0
    assert torch.equal(pt_mod.sample_paths(textured, cfg, 0, pix)[0], plain)
