"""The port's general splat, DBOR cascade, rgb2spec LUT and vis AOVs
against the JAX package (1e-5), and ``--dbor`` / ``--sampler vis`` through
the command line on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.ops import splat as jsplat
from corona13_tpu.samplers import pt as jpt
from corona13_tpu.samplers import vis as jvis
from corona13_tpu.spectral import rgb2spec as jr2s
from corona13_tpu_torch import __main__ as cli
from corona13_tpu_torch import convert
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch.io import pfm as pfm_io
from corona13_tpu_torch.ops import splat
from corona13_tpu_torch.samplers import pt as pt_mod
from corona13_tpu_torch.samplers import vis
from corona13_tpu_torch.spectral import rgb2spec

H, W = 12, 20
MB = 'data/golden/scenes/0002_mb/test.nra2'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n, seed):
    """Image positions (some outside the image, some on its border) and
    colours spanning five decades."""
    g = np.random.default_rng(seed)
    pi = g.uniform(-2.0, W + 2.0, n).astype(np.float32)
    pj = g.uniform(-2.0, H + 2.0, n).astype(np.float32)
    pi[:4] = [0.0, W - 1e-3, 0.5, W / 2]
    pj[:4] = [0.0, H - 1e-3, H - 0.5, 0.25]
    col = (10.0 ** g.uniform(-2, 3, (n, 3))).astype(np.float32)
    return pi, pj, col


@pytest.mark.parametrize('kind', ['box', 'bilin', 'spline', 'gaussian',
                                  'blackmanharris'])
def test_splat_matches_jax(kind):
    pi, pj, col = _samples(500, 0)
    fb = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    want = np.asarray(jsplat.splat(jnp.asarray(fb), jnp.asarray(pi),
                                   jnp.asarray(pj), jnp.asarray(col),
                                   filter_kind=kind))
    tfb = torch.as_tensor(fb)
    got = splat.splat(tfb, torch.as_tensor(pi), torch.as_tensor(pj),
                      torch.as_tensor(col), filter_kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * want.max())
    np.testing.assert_array_equal(tfb.numpy(), fb)      # out of place


def test_splat_differentiable_in_col():
    """d sum(fb * g) / d col: each sample's normalized taps gather g."""
    pi, pj, col = _samples(64, 2)
    inside = (pi >= 0) & (pi < W) & (pj >= 0) & (pj < H)
    c = torch.as_tensor(col, dtype=torch.float32).requires_grad_()
    fb = splat.splat(torch.zeros(H, W, 3), torch.as_tensor(pi),
                     torch.as_tensor(pj), c)
    fb.sum().backward()
    # the taps of a sample sum to 1, so each colour weighs 1 in the sum
    np.testing.assert_allclose(c.grad.numpy()[inside], 1.0, rtol=1e-5)
    assert np.isfinite(c.grad.numpy()).all()


def test_dbor_matches_jax():
    pi, pj, col = _samples(800, 3)
    fbs = np.zeros((jsplat.N_DBOR, H, W, 3), np.float32)
    want = jsplat.splat_dbor(jnp.asarray(fbs), jnp.asarray(pi),
                             jnp.asarray(pj), jnp.asarray(col))
    got = splat.splat_dbor(torch.as_tensor(fbs), torch.as_tensor(pi),
                           torch.as_tensor(pj), torch.as_tensor(col))
    assert splat.N_DBOR == jsplat.N_DBOR == got.shape[0]
    # log2 differs by an ulp between XLA and torch, which moves the split
    # between two levels by 1e-6 of the colour: 1e-5 of the largest value
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.asarray(want).max()))
    # the cascade splits each sample between two levels: nothing is lost
    xi = np.clip(pi.astype(np.int32), 0, W - 1)
    yi = np.clip(pj.astype(np.int32), 0, H - 1)
    total = np.zeros((H, W, 3), np.float32)
    np.add.at(total, (yi, xi), col)
    np.testing.assert_allclose(got.numpy().sum(axis=0), total, rtol=1e-4)
    for trust in (4.0, 1.0):
        wm = np.asarray(jsplat.dbor_merge(want, spp=4, trust=trust))
        gm = splat.dbor_merge(got, trust=trust).numpy()
        np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-5 * wm.max())
    assert gm.sum() < total.sum()          # lone bright splats attenuated


def test_fetch_lut_matches_jax(tmp_path):
    """A res-6 LUT built by the port: its fetch against the JAX fetch on
    the same table, its coefficients against the JAX fit, its file
    format read back by the JAX class."""
    lut = rgb2spec.build_lut(res=6, device='cpu')
    assert lut.data.shape == (3, 6, 6, 6, 3) and np.isfinite(lut.data).all()
    g = np.random.default_rng(4)
    rgb = g.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    rgb[:3] = [[1, 1, 1], [0.2, 0.2, 0.2], [1e-5, 0, 0]]
    want = np.asarray(jr2s.fetch_lut(jnp.asarray(lut.scale),
                                     jnp.asarray(lut.data), jnp.asarray(rgb)))
    got = rgb2spec.fetch_lut(torch.as_tensor(lut.scale),
                             torch.as_tensor(lut.data),
                             torch.as_tensor(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the grid's spectra against the JAX fit of the same colours
    lam = np.linspace(400, 700, 7).astype(np.float32)
    rows = np.stack([np.array([lut.scale[z], lut.scale[z] * 0.4,
                               lut.scale[z] * 0.8], np.float32)
                     for z in (1, 3, 5)])
    cj = jr2s.fit_coeff(jnp.asarray(rows))
    ct = rgb2spec.fetch_lut(torch.as_tensor(lut.scale),
                            torch.as_tensor(lut.data), torch.as_tensor(rows))
    np.testing.assert_allclose(
        rgb2spec.eval_coeff(ct[:, None, :], torch.as_tensor(lam)).numpy(),
        np.asarray(jr2s.eval_coeff(cj[:, None, :], jnp.asarray(lam))),
        atol=2e-4)
    lut.save(str(tmp_path / 'lut.spec'))
    back = jr2s.Rgb2SpecLUT.load(str(tmp_path / 'lut.spec'))
    np.testing.assert_array_equal(back.data, lut.data)
    again = rgb2spec.Rgb2SpecLUT.load(str(tmp_path / 'lut.spec'))
    np.testing.assert_array_equal(again.scale, lut.scale)
    assert again.res == 6


@pytest.mark.parametrize('kind', ['normals', 'depth', 'prim', 'shader', 'uv'])
def test_render_aov_matches_jax(kind):
    js = jscene.fit_film(jtesting.cornell_scene(sphere='diffuse'), 32, 24)
    ts = convert.scene_from_numpy(js, device='cpu')
    want = np.asarray(jvis.render_aov(
        js, jpt.PTConfig(width=32, height=24, mf=2), jnp.uint32(1), kind=kind))
    got = vis.render_aov(ts, pt_mod.PTConfig(width=32, height=24, mf=2), 1,
                         kind=kind).numpy()
    assert got.shape == (24, 32, 3) and want.max() > 0
    # a ray through a quad's diagonal may take either half (see
    # tests/test_torch_render.py): the ids and uv of such a pixel differ
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    with pytest.raises(ValueError):
        vis.render_aov(ts, pt_mod.PTConfig(width=32, height=24), 0, kind='x')


def test_cli_dbor(tmp_path):
    """--dbor writes the cascade levels and a merged image within 5% of
    the plain render's mean (0002_mb is lit evenly: nothing to reject)."""
    out = str(tmp_path / 'd')
    args = [MB, '-s', '2', '-w', '32', '-h', '32', '--max-verts', '4',
            '--device', 'cpu']
    assert cli.main(args + ['--dbor', '-x', out]) == 0
    levels = [pfm_io.read_pfm(f'{out}_dbor{k:02d}.pfm')
              for k in range(splat.N_DBOR)]
    assert all(l.shape == (32, 32, 3) for l in levels)
    merged = pfm_io.read_pfm(out + '_fb00.pfm')
    assert np.isfinite(merged).all() and merged.mean() > 0
    plain = str(tmp_path / 'p')
    assert cli.main(args + ['-x', plain]) == 0
    ref = pfm_io.read_pfm(plain + '_fb00.pfm')
    assert abs(merged.mean() - ref.mean()) < 0.05 * ref.mean(), \
        (merged.mean(), ref.mean())


def test_cli_vis_and_unported_samplers(tmp_path):
    """--sampler vis writes its AOVs; ppm, kmlt and vmlt, which the CLI
    once refused with exit 2, have a branch now (their renders are
    test_torch_scene.test_cli_mlt_ppm_samplers)."""
    out = str(tmp_path / 'v')
    for aov in ('normals', 'depth'):
        assert cli.main([MB, '-w', '32', '-h', '32', '--sampler', 'vis',
                         '--aov', aov, '-x', out, '--device', 'cpu']) == 0
        img = pfm_io.read_pfm(out + '_fb00.pfm')
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
        assert img.max() > 0 and img.max() <= 1.0
    assert {'ppm', 'kmlt', 'vmlt'} <= set(render_mod.SAMPLERS)
