"""The hair frame as raw inputs, for a later cell: the generator of
``chip_smoke.py`` ``_hair_scene`` (lines 1876-1917 as of commit 2084081),
frozen here and returned as arrays.  ``n_fibers`` HAIR fibres (tapered
cones 1-2 units tall, ``radii`` at root and tip) on a 20 x 25 diffuse
ground under a constant sky and a small area light, drawn from ``seed``;
the camera at the origin looks down +z over them.
"""

from __future__ import annotations

import numpy as np


def inputs(n_fibers=1 << 16, seed=0, radii=(0.1, 0.06)):
    g = np.random.default_rng(seed)
    mats = [dict(d_rgb=(0.5, 0.5, 0.5)),
            dict(kind='HAIR', d_rgb=(0.6, 0.4, 0.3), g_rgb=(0.3, 0.3, 0.3),
                 roughness=0.2),
            dict(e_rgb=(30.0, 30.0, 30.0))]
    y0 = -3.0
    ground = np.array([[[-10, y0, 5], [10, y0, 30], [10, y0, 5]],
                       [[-10, y0, 5], [-10, y0, 30], [10, y0, 30]]],
                      np.float32)
    light = np.array([[[-1, 6, 14], [1, 6, 14], [1, 6, 16]],
                      [[-1, 6, 14], [1, 6, 16], [-1, 6, 16]]], np.float32)
    root = np.stack([g.uniform(-9, 9, n_fibers), np.full(n_fibers, y0),
                     g.uniform(6, 29, n_fibers)], axis=-1)
    tip = root + np.stack([g.normal(0, 0.25, n_fibers),
                           g.uniform(1.0, 2.0, n_fibers),
                           g.normal(0, 0.25, n_fibers)], axis=-1)
    cam = dict(pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
               orient=np.array([1, 0, 0, 0], np.float32),
               orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    kw = dict(sky_rgb=(1.0, 1.0, 1.0),
              line_vtx=np.stack([root, tip], axis=1).astype(np.float32),
              line_radii=np.tile(np.array([radii], np.float32),
                                 (n_fibers, 1)),
              line_sh=np.ones(n_fibers, np.int32))
    return (np.concatenate([ground, light]), np.array([0, 0, 2, 2], np.int32),
            mats, cam, kw)
