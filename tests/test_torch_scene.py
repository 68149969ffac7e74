"""The port's scene loader and CLI against the JAX package.

``load_scene`` of both packages on the three in-repo scenes, leaf by leaf:
every BVH array, integer table and flag equal; every float table within
rtol 1e-6 / atol 1e-6, except the sigmoid-polynomial fits.  Those come
from two Gauss-Newton fitters (jax and torch) whose coefficients differ by
up to ~1e-3 where the fit is flat (white and black inputs); the spectra
they evaluate to agree within 1e-4 (as tests/test_torch_trace.py holds
them).  The JAX package's BVH comes from its numpy reference builder here:
its native C++ builder breaks exact SAH cost ties by FMA rounding (see
``test_bvh_matches_numpy_reference_builder``).

The golden-image gates of tests/test_golden.py:134-173 have a slow-marked
twin on the port at the same settings and bounds.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu.io import nra2 as jnra2
from corona13_tpu.ops import bvh as jbvh
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch.io import fb as tfb
from corona13_tpu_torch.io import nra2 as tnra2
from corona13_tpu_torch.io import pfm as tpfm
from corona13_tpu_torch.spectral import rgb2spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCENES = os.path.join(ROOT, 'data', 'golden', 'scenes')
NAMES = ['0002_mb', '0030_subsurf', '0031_hete']
_FITS = {'d_coeff': 'd_mul', 'g_coeff': 'g_mul', 'e_coeff': 'e_mul',
         'med_mut_coeff': 'med_mut_mul', 'med_mus_coeff': 'med_mus_mul'}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several xdist
    workers, whose torch thread pools would oversubscribe the cores (up to
    50x slower here), and these small wavefronts gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(name):
    return os.path.join(_SCENES, name, 'test.nra2')


def _walk(j, t, path, out):
    """Collect (path, jax leaf, port leaf) over the JAX dataclass tree."""
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            jv = getattr(j, f.name)
            if not hasattr(t, f.name):
                assert jv is None, f'{path}.{f.name} not carried'
                continue
            _walk(jv, getattr(t, f.name), f'{path}.{f.name}', out)
    else:
        out.append((path, j, t))


@pytest.mark.parametrize('name', NAMES)
def test_load_scene_tables_match_jax(name, monkeypatch):
    monkeypatch.setattr(jbvh, '_build_bvh_native', lambda a, b: None)
    js, jcd = jscene.load_scene(_path(name))
    ts, tcd = tscene.load_scene(_path(name), device='cpu')
    leaves = []
    _walk(js, ts, 'scene', leaves)
    assert len(leaves) > 60
    lam = torch.linspace(360, 830, 95)
    for path, j, t in leaves:
        if j is None or isinstance(j, (bool, int, float, str, tuple)):
            assert j == t, path
            continue
        a, b = np.asarray(j), t.numpy()
        assert a.shape == b.shape, path
        key = path.split('.')[-1]
        if key in _FITS or key == 'sky_coeff':
            mul = (getattr(ts.materials, _FITS[key])[:, None] if key in _FITS
                   else ts.sky_mul)
            ours = mul * rgb2spec.eval_coeff(t[..., None, :], lam)
            theirs = mul * rgb2spec.eval_coeff(torch.as_tensor(a)[..., None, :],
                                               lam)
            scale = torch.clamp(mul, min=1.0)
            assert ((ours - theirs).abs() / scale).max() < 1e-4, path
        elif a.dtype.kind in 'biu':
            np.testing.assert_array_equal(b, a, path)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=path)
    for f in dataclasses.fields(jcd):
        np.testing.assert_array_equal(getattr(tcd, f.name),
                                      getattr(jcd, f.name), f.name)
    assert ts.geom.tri_bvh.wbounds is not None


def test_scene_flags():
    """What each in-repo scene exercises (PERF.md section 4)."""
    hete, _ = tscene.load_scene(_path('0031_hete'), device='cpu')
    assert hete.has_hete and hete.exterior_med == hete.vol.mat_id == 13
    assert not hete.has_vol_emission and hete.geom.n_tris == 8210
    assert tuple(hete.vol.density.shape) == (64, 64, 64)
    sub, _ = tscene.load_scene(_path('0030_subsurf'), device='cpu')
    assert sub.geom.n_tris == 8198 and sub.geom.n_spheres == 0
    assert sub.kinds_used == (tscene.DIFFUSE, tscene.DIFFDIEL)
    assert bool(sub.materials.med_enabled.any()) and sub.vol is None
    mb, _ = tscene.load_scene(_path('0002_mb'), device='cpu')
    assert mb.geom.has_motion and mb.materials.use_checker.any()
    assert tscene.align32(250) == 256 and tscene.align32(256) == 256


def test_missing_geo_is_skipped(capsys):
    tscene.load_scene(_path('0030_subsurf'), device='cpu')
    assert "could not load geo `../geo/skincube.geo', skipping shape" in \
        capsys.readouterr().out


def test_bvh_matches_numpy_reference_builder():
    """The JAX package's native builder (FMA-contracted float32 SAH cost,
    in the committed libcorona13.so) and its numpy reference builder
    (float64 cost) pick different splits where SAH costs tie, as on
    0031_hete's planar ground mesh; the port follows the numpy reference
    bit for bit.  Every tree holds every triangle once."""
    from corona13_tpu_torch.io import geo as tgeo
    from corona13_tpu_torch.ops import bvh as tbvh
    desc = tnra2.parse_nra2(_path('0031_hete'))
    tri = np.concatenate([tgeo.load_geo(s.geo_path).tri_vtx
                          for s in desc.shapes if os.path.exists(s.geo_path)])
    ours = tbvh.build_bvh(*tbvh.tri_bounds(tri))
    ref = jbvh.build_bvh(*jbvh.tri_bounds(tri))        # native where built
    jbvh_native, jbvh._build_bvh_native = jbvh._build_bvh_native, \
        lambda a, b: None
    try:
        numpy_ref = jbvh.build_bvh(*jbvh.tri_bounds(tri))
    finally:
        jbvh._build_bvh_native = jbvh_native
    for f in ('node_min', 'node_max', 'node_skip', 'node_first',
              'node_right', 'leaf_prims'):
        np.testing.assert_array_equal(getattr(ours, f),
                                      getattr(numpy_ref, f), f)
    for t in (ref, ours):
        lp = t.leaf_prims[t.leaf_prims >= 0]
        np.testing.assert_array_equal(np.sort(lp), np.arange(len(tri)))


def test_parse_nra2_matches_jax():
    for name in NAMES:
        a, b = tnra2.parse_nra2(_path(name)), jnra2.parse_nra2(_path(name))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_framebuffer_and_pfm_match_jax(tmp_path):
    from corona13_tpu.io import fb as jfb
    from corona13_tpu.io import pfm as jpfm
    img = np.random.default_rng(0).uniform(0, 2, (6, 9, 3)).astype(np.float32)
    paths = []
    for mod, tag in ((tfb, 't'), (jfb, 'j')):
        f = mod.Framebuffer.open(str(tmp_path / f'{tag}.fb'), 9, 6)
        f.accumulate(img, 2)
        f.accumulate(img, 1)
        f.flush(iso=200.0)
        paths.append(tmp_path / f'{tag}.fb')
    assert paths[0].read_bytes() == paths[1].read_bytes()
    back = tfb.Framebuffer.open(str(paths[0]), 9, 6, retain=True)
    assert back.spp == 3 and np.allclose(back.image, jfb.Framebuffer.load(
        str(paths[1])).image)
    assert tfb.Framebuffer.open(str(paths[0]), 9, 6, retain=False).spp == 0
    tpfm.write_pfm(str(tmp_path / 'a.pfm'), img)
    np.testing.assert_array_equal(tpfm.read_pfm(str(tmp_path / 'a.pfm')),
                                  jpfm.read_pfm(str(tmp_path / 'a.pfm')))
    assert tpfm.rmse(img, img * 0.5) == jpfm.rmse(img, img * 0.5)


def _cli(*args, timeout=300):
    # one torch thread, as in _one_torch_thread
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', 'corona13_tpu_torch', *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_renders_on_the_cpu(tmp_path):
    """python -m corona13_tpu_torch on the CPU: 32x32 after align32, 1 spp,
    media on; writes the PFM, the .fb checkpoint and the sidecar, and a
    second run with --retain-framebuffer resumes at 1 spp."""
    out = str(tmp_path / 'r')
    args = (_path('0031_hete'), '-s', '1', '-w', '20', '-h', '30', '--media',
            '--device', 'cpu', '-x', out)
    p = _cli(*args)
    assert p.returncode == 0, p.stderr[-2000:]
    img = tpfm.read_pfm(out + '_fb00.pfm')
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    text = open(out + '.txt').read()
    assert 'size     : 32x32' in text and 'device   : cpu' in text
    p = _cli(*args, '--retain-framebuffer')
    assert p.returncode == 0 and 'resuming at 1 spp' in p.stdout
    assert tfb.Framebuffer.load(out + '.fb').spp == 2


def test_cli_refuses_what_it_cannot_do(tmp_path):
    """No silent CPU fallback without a card (for ``--dbor``, the vis
    sampler and the MLT samplers neither)."""
    out = str(tmp_path / 'r')
    if not torch.cuda.is_available():
        p = _cli(_path('0031_hete'), '-x', out, timeout=120)
        assert p.returncode != 0 and 'no CUDA device' in p.stderr
        assert not os.path.exists(out + '_fb00.pfm')
        for extra in (('--sampler', 'vis'), ('--dbor',),
                      ('--sampler', 'kmlt')):
            p = _cli(_path('0031_hete'), '-x', out, *extra, timeout=120)
            assert p.returncode != 0 and 'no CUDA device' in p.stderr


@pytest.mark.parametrize('sampler', ['lt', 'bdpt', 'ptlt', 'bdpt1'])
def test_cli_light_path_samplers(tmp_path, sampler):
    """--sampler lt|bdpt|ptlt|bdpt1 on the CPU: 0002_mb at 32x32, 2 spp,
    a finite image with signal, the sidecar naming the sampler."""
    out = str(tmp_path / sampler)
    p = _cli(_path('0002_mb'), '--sampler', sampler, '-s', '2', '-w', '32',
             '-h', '32', '--max-verts', '5', '--device', 'cpu', '-x', out)
    assert p.returncode == 0, p.stderr[-2000:]
    assert '[2/2]' in p.stdout and 's/frame' in p.stdout
    img = tpfm.read_pfm(out + '_fb00.pfm')
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    assert f'sampler  : {sampler}' in open(out + '.txt').read()
    assert tfb.Framebuffer.load(out + '.fb').spp == 2


@pytest.mark.parametrize('sampler', ['ppm', 'kmlt', 'vmlt'])
def test_cli_mlt_ppm_samplers(tmp_path, sampler):
    """--sampler ppm|kmlt|vmlt on the CPU: 0002_mb at 32x32, 2 spp,
    max_verts 4 (the CLI has no --chains: kmlt and vmlt run the reference
    default of 8192 chains, 9 replays a progression at this size), a
    finite image with signal, the sidecar naming the sampler; ``--dbor``
    does not apply to them, as in the JAX CLI."""
    out = str(tmp_path / sampler)
    p = _cli(_path('0002_mb'), '--sampler', sampler, '-s', '2', '-w', '32',
             '-h', '32', '--max-verts', '4', '--dbor', '--device', 'cpu',
             '-x', out)
    assert p.returncode == 0, p.stderr[-2000:]
    assert '[2/2]' in p.stdout and 's/frame' in p.stdout
    img = tpfm.read_pfm(out + '_fb00.pfm')
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    assert f'sampler  : {sampler}' in open(out + '.txt').read()
    assert tfb.Framebuffer.load(out + '.fb').spp == 2
    assert not os.path.exists(out + '_dbor00.pfm')


def test_cli_samplers_match_the_reference():
    """The port's --sampler choices are the JAX CLI's (read from its
    parser's source: importing it would import jax), and every one of
    them has a branch."""
    import ast
    from corona13_tpu_torch import __main__ as cli
    from corona13_tpu_torch import render
    src = open(os.path.join(ROOT, 'corona13_tpu', '__main__.py')).read()
    choices = [
        ast.literal_eval(kw.value) for node in ast.walk(ast.parse(src))
        if isinstance(node, ast.Call) and node.args
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == '--sampler'
        for kw in node.keywords if kw.arg == 'choices']
    assert choices == [cli._SAMPLERS]
    # every sampler but vis runs through render.render (ptdl as pt with
    # NEE), vis through its AOV
    assert set(cli._SAMPLERS) == set(render.SAMPLERS) | {'ptdl', 'vis'}
    assert not set(render.SAMPLERS) & {'ptdl', 'vis'}


# --- golden gates, the port's twins of tests/test_golden.py:134-173 --------

GOLDEN = os.path.join(ROOT, 'data', 'golden')


def _down(img, f):
    h, w, c = img.shape
    return img.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


@pytest.mark.slow
def test_hete_matches_reference():
    """0031_hete gate at the JAX test's settings and bounds."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    sc, _ = tscene.load_scene(_path('0031_hete'), device='cpu')
    sc = tscene.fit_film(sc, 64, 40)
    cfg = pt_mod.PTConfig(width=64, height=40, max_verts=12, mf=2,
                          use_nee=True)
    res = render_mod.render(sc, cfg, spp=16, batch=8)
    gold = _down(tpfm.read_pfm(os.path.join(GOLDEN, '0031_hete.pfm')), 4)
    rmse = tpfm.rmse(res.image_xyz, gold)
    mean_rel = abs(res.image_xyz.mean() - gold.mean()) / gold.mean()
    assert rmse < 0.06, f'RMSE {rmse}'
    assert mean_rel < 0.12, f'mean energy off by {mean_rel:.1%}'


@pytest.mark.slow
def test_subsurf_matches_reference():
    """0030_subsurf gate at the JAX test's settings and bounds."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    sc, _ = tscene.load_scene(_path('0030_subsurf'), device='cpu')
    sc = tscene.fit_film(sc, 128, 80)
    cfg = pt_mod.PTConfig(width=128, height=80, max_verts=8, mf=4,
                          use_nee=True)
    res = render_mod.render(sc, cfg, spp=12, batch=4)
    gold = _down(tpfm.read_pfm(os.path.join(GOLDEN, '0030_subsurf.pfm')), 2)
    rmse = tpfm.rmse(res.image_xyz, gold)
    mean_rel = abs(res.image_xyz.mean() - gold.mean()) / gold.mean()
    assert rmse < 0.2, f'RMSE {rmse} vs reference gate 0.35'
    assert mean_rel < 0.05, f'mean energy off by {mean_rel:.1%}'
