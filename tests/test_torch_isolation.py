"""The port runs without JAX: a fresh interpreter imports
corona13_tpu_torch, builds cornell_scene and the plane scene, renders one
16x9 progression on the CPU, loads 0031_hete with scene.load_scene and
traces one 16x9 media progression of it, and neither jax, flax nor any
module of the JAX package corona13_tpu gets imported."""

import os
import subprocess
import sys

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
