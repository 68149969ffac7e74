"""The port runs without JAX: a fresh interpreter imports
corona13_tpu_torch, builds cornell_scene and the plane scene, renders one
16x9 progression on the CPU, loads 0031_hete with scene.load_scene and
traces one 16x9 media progression of it, renders a frame under an envmap
(models.envmap) and one under a daylight sky (models.daylight), a compacted
frame, a gradient, a vis AOV (samplers.vis), a DBOR cascade and one 16x9
progression of each light-path sampler (samplers.lt, bdpt, ptlt, bdpt1, with
lights.sample_emission, camera.connect and the sampling helpers of
utils.math; bdpt once more through render.render) and of ppm, kmlt and vmlt (pt's primary-sample replay), a
sharded render and a train step over an emulated (2, 2) mesh
(parallel.shard), writes and reads back a .cam, .geo and .vol file (the io
writers) and runs the tools (pfmdiff, welch, obj2geo, netdisplay's
tonemap), and neither jax, flax nor any module of the JAX package
corona13_tpu gets imported.

The port's layers, read from its imports with ``ast``: only the kernel
library module ``ops/cuda_lib.py`` builds and loads code (ctypes,
subprocess, hashlib); no kernel binding imports another; ``tracing``, the
bottom layer, imports nothing from ``ops``; and the CLI chooses no
estimator (``render.render`` does): it imports no sampler module but vis
and pt (for ``--dbor``)."""

import ast
import os
import subprocess
import sys

import pytest

_SCRIPT = """
import sys
import numpy as np
import corona13_tpu_torch
from corona13_tpu_torch import render, testing
from corona13_tpu_torch.samplers import pt
sc = testing.cornell_scene(sphere='diffuse', device='cpu')
res = render.render(sc, pt.PTConfig(width=16, height=9, max_verts=4), spp=1)
assert res.image_xyz.shape == (9, 16, 3) and np.isfinite(res.image_xyz).all()
assert res.image_xyz.max() > 0
assert testing.plane_scene(device='cpu').geom.n_tris == 8198
from corona13_tpu_torch import scene
hete, _ = scene.load_scene('data/golden/scenes/0031_hete/test.nra2',
                           device='cpu')
hete = scene.fit_film(hete, 16, 9)
img = pt.render_sample(hete, pt.PTConfig(width=16, height=9, max_verts=4,
                                         media=True), 0).numpy()
assert np.isfinite(img).all()
import dataclasses
import torch
from corona13_tpu_torch.models import daylight, envmap
from corona13_tpu_torch.ops import splat
from corona13_tpu_torch.samplers import vis
cfg = pt.PTConfig(width=16, height=9, max_verts=4)
fur = testing.furnace_scene(albedo=0.6, emission=0.0, device='cpu')
env = fur.with_envmap(envmap.make_gradient_sky(sun_dir=(0.3, 0.2, 0.9),
                                               res=(8, 16)))
day = dataclasses.replace(fur, has_daylight=True, daylight=daylight.build(
    (0.3, 0.2, 0.9), 2.5, device='cpu'))
for s in (env, day):
    img = pt.render_sample(s, cfg, 0).numpy()
    assert np.isfinite(img).all() and img.max() > 0
img = pt.render_sample(sc, cfg.replace(compact=(1.0, 0.8, 0.5)), 0).numpy()
assert np.isfinite(img).all() and img.max() > 0
theta = torch.tensor(1.0, requires_grad=True)
mats = dataclasses.replace(sc.materials, d_mul=sc.materials.d_mul * theta)
pt.render_sample(dataclasses.replace(sc, materials=mats), cfg, 0).mean().backward()
assert float(theta.grad) > 0
assert vis.render_aov(sc, cfg, 0, kind='normals').shape == (9, 16, 3)
fbs = splat.splat_dbor(torch.zeros(splat.N_DBOR, 9, 16, 3), torch.rand(50) * 16,
                       torch.rand(50) * 9, torch.rand(50, 3) * 40)
assert np.isfinite(splat.dbor_merge(fbs).numpy()).all()
from corona13_tpu_torch.samplers import bdpt, bdpt1, lt, ptlt
res = render.render(sc, cfg.replace(sampler='bdpt'), spp=1)
assert res.fb.shape == (9, 16, 3) and np.isfinite(res.fb).all()
assert res.fb.max() > 0
for render in (lt.render_sample, bdpt.render_sample, ptlt.render_sample):
    img = render(sc, cfg, 0).numpy()
    assert img.shape == (9, 16, 3) and np.isfinite(img).all() and img.max() > 0
img, table = bdpt1.render_sample(sc, cfg, 0, bdpt1.ConfigTable.create(cfg))
assert np.isfinite(img.numpy()).all() and table.count.sum() == 1
from corona13_tpu_torch.samplers import kmlt, ppm, vmlt
for img in (ppm.render_sample(sc, cfg, 0),
            kmlt.render_sample(sc, cfg, 0, chains=64),
            vmlt.render_sample(sc, cfg, 0, chains=64)):
    img = img.numpy()
    assert img.shape == (9, 16, 3) and np.isfinite(img).all() and img.max() > 0
from corona13_tpu_torch.parallel import dryrun, shard
mesh = shard.make_mesh(2, 2)
fb = shard.render_samples_sharded(sc, cfg, mesh, 0, emulate=True, device='cpu')
assert fb.shape == (9, 16, 3) and float(fb.sum()) > 0
(loss, img), grads = shard.train_step_theta(
    sc, cfg, mesh, fb * 0.25, {'d_mul': torch.tensor(1.0),
                              'e_mul': torch.tensor(1.0),
                              'med_sigma': torch.tensor(1.0),
                              'focus': torch.tensor(1.0)},
    emulate=True, device='cpu')
assert float(grads['e_mul']) > 0
import os, tempfile
from corona13_tpu_torch.io import cam, geo, pfm, vol
from corona13_tpu_torch.tools import netdisplay, obj2geo, pfmdiff, welch
with tempfile.TemporaryDirectory() as tmp:
    p = lambda name: os.path.join(tmp, name)
    c = cam.read_cam('data/golden/scenes/0002_mb/test01.cam')
    cam.write_cam(p('a.cam'), c)
    assert cam.read_cam(p('a.cam')).focus == c.focus
    tri = np.random.default_rng(0).uniform(-1, 1, (4, 3, 3)).astype(np.float32)
    geo.save_geo(p('a.geo'), tri, tri_vtx_t1=tri + 1)
    assert geo.load_geo(p('a.geo')).has_motion
    geo.write_geo(p('b.geo'), tri)
    assert (geo.load_geo(p('b.geo')).tri_vtx == tri).all()
    vol.write_vol(p('a.vol'), np.ones((8, 8, 8), np.float32))
    assert vol.read_vol(p('a.vol')).density.shape == (64, 64, 64)
    with open(p('a.obj'), 'w') as f:
        f.write('v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n')
    assert obj2geo.main([p('a.obj'), p('c.geo')]) == 0
    pfm.write_pfm(p('a.pfm'), np.ones((64, 64, 3), np.float32))
    assert pfmdiff.main([p('a.pfm'), p('a.pfm')]) == 0
    assert welch.main([p('a.pfm'), p('a.pfm')]) == 0
    assert netdisplay._tonemap(np.ones((2, 2, 3), np.float32)).max() > 0
for mod in ('models.envmap', 'models.daylight', 'samplers.vis', 'samplers.lt',
            'samplers.bdpt', 'samplers.ptlt', 'samplers.bdpt1',
            'samplers.ppm', 'samplers.kmlt', 'samplers.vmlt',
            'parallel.shard', 'parallel.dryrun', 'tools.netdisplay',
            'tools.obj2geo', 'tools.pfmdiff', 'tools.welch'):
    assert 'corona13_tpu_torch.' + mod in sys.modules, mod
leaked = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'flax', 'corona13_tpu')]
assert not leaked, leaked
print('ISOLATED')
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'ISOLATED' in out.stdout


PORT = 'corona13_tpu_torch'
BINDINGS = {f'{PORT}.ops.{m}' for m in ('trace_cuda', 'hete_cuda',
                                         'splat_cuda', 'rng_cuda')}


def _port_imports():
    """{module of the port: the absolute names it imports anywhere in its
    file}; ``from a import b`` names a and a.b."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for d, _, files in os.walk(os.path.join(root, PORT)):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(d, f)
            parts = os.path.relpath(path, root)[:-3].split(os.sep)
            pkg = parts[:-1]
            if parts[-1] == '__init__':
                parts = pkg
            names = set()
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names |= {a.name for a in node.names}
                elif isinstance(node, ast.ImportFrom):
                    base = pkg[:len(pkg) - node.level + 1] if node.level \
                        else []
                    mod = '.'.join(base + ([node.module] if node.module
                                           else []))
                    names |= {mod} | {f'{mod}.{a.name}' for a in node.names}
            out['.'.join(parts)] = names
    return out


@pytest.mark.parametrize('rule', ['ffi', 'bindings', 'tracing', 'cli'])
def test_port_layering(rule):
    imports = _port_imports()
    if rule == 'ffi':
        ffi = {'ctypes', 'subprocess', 'hashlib'}
        assert ffi <= imports[f'{PORT}.ops.cuda_lib']
        bad = {m for m, names in imports.items()
               if names & ffi and m != f'{PORT}.ops.cuda_lib'}
    elif rule == 'bindings':
        assert all(f'{PORT}.ops.cuda_lib' in imports[m] for m in BINDINGS)
        bad = {m for m in BINDINGS if imports[m] & (BINDINGS - {m})}
    elif rule == 'tracing':
        bad = {n for n in imports[f'{PORT}.tracing']
               if n == f'{PORT}.ops' or n.startswith(f'{PORT}.ops.')}
    else:
        assert f'{PORT}.render' in imports[f'{PORT}.__main__']
        bad = {n for n in imports[f'{PORT}.__main__']
               if n.startswith(f'{PORT}.samplers.')} - {
            f'{PORT}.samplers.vis', f'{PORT}.samplers.pt'}
    assert not bad, bad
