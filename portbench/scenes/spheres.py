"""The sphere frame as raw inputs, for a later cell: ``chip_smoke.py``
``_sphere_inputs`` (lines 1920-1949 as of commit 2084081), frozen here.
``n_spheres`` spheres (centres uniform over x in [-9, 9], y in [-3, 1],
z in [6, 29], radii uniform in [0.05, 0.25]; a quarter rough METAL, the
rest DIFFUSE) on the hair scene's ground under its sky and light, drawn
from ``seed``.
"""

from __future__ import annotations

import numpy as np


def inputs(n_spheres=1 << 16, seed=0):
    g = np.random.default_rng(seed)
    mats = [dict(d_rgb=(0.5, 0.5, 0.5)), dict(e_rgb=(30.0, 30.0, 30.0)),
            dict(d_rgb=(0.6, 0.45, 0.3)),
            dict(kind='METAL', g_rgb=(1.0, 1.0, 1.0), roughness=0.3)]
    y0 = -3.0
    ground = np.array([[[-10, y0, 5], [10, y0, 30], [10, y0, 5]],
                       [[-10, y0, 5], [-10, y0, 30], [10, y0, 30]]],
                      np.float32)
    light = np.array([[[-1, 6, 14], [1, 6, 14], [1, 6, 16]],
                      [[-1, 6, 14], [1, 6, 16], [-1, 6, 16]]], np.float32)
    c = np.stack([g.uniform(-9, 9, n_spheres), g.uniform(-3, 1, n_spheres),
                  g.uniform(6, 29, n_spheres)], axis=-1).astype(np.float32)
    rad = g.uniform(0.05, 0.25, n_spheres).astype(np.float32)
    sh = np.where(g.uniform(size=n_spheres) < 0.25, 3, 2).astype(np.int32)
    cam = dict(pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
               orient=np.array([1, 0, 0, 0], np.float32),
               orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    return (np.concatenate([ground, light]), np.array([0, 0, 1, 1], np.int32),
            mats, cam, dict(sky_rgb=(1.0, 1.0, 1.0), sph_c=c, sph_r=rad,
                            sph_sh=sh))
