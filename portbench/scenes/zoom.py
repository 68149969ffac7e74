"""The zoom frame as raw inputs, for a later cell: ``chip_smoke.py``
``zoom_ribbon`` and ``_zoom_inputs`` (lines 1965-2016 as of commit
2084081), frozen here.  A 65,536-triangle log-spiral ribbon at the
origin whose binned-SAH tree is too deep for the wide stack (the deep
walk's form), a quarter rough METAL, a ground behind it, an area light
above the camera, a constant sky; the camera on +z at z = 3.
"""

from __future__ import annotations

import numpy as np


def zoom_ribbon(n_tris=1 << 16, shrink=0.99902, step=0.02):
    """Sample k at radius R = shrink**k and angle a = step*k has the inner
    edge point (R cos a, R sin a, 0.05 R sin 7a) and the outer (1.3 R cos
    a, 1.3 R sin a, 0.05 R cos 7a); consecutive samples make (a_k, b_k,
    a_k+1) and (a_k+1, b_k, b_k+1).  [n_tris, 3, 3] f32 (computed in
    f64)."""
    k = np.arange(n_tris // 2 + 1, dtype=np.float64)
    rad, th = shrink ** k, step * k
    a = np.stack([rad * np.cos(th), rad * np.sin(th),
                  0.05 * rad * np.sin(7 * th)], axis=-1)
    b = np.stack([1.3 * rad * np.cos(th), 1.3 * rad * np.sin(th),
                  0.05 * rad * np.cos(7 * th)], axis=-1)
    tri = np.stack([np.stack([a[:-1], b[:-1], a[1:]], axis=1),
                    np.stack([a[1:], b[:-1], b[1:]], axis=1)], axis=1)
    return tri.reshape(-1, 3, 3).astype(np.float32)


def inputs(n_tris=1 << 16, seed=0):
    g = np.random.default_rng(seed)
    ribbon = zoom_ribbon(n_tris)
    mats = [dict(d_rgb=(0.5, 0.5, 0.5)), dict(e_rgb=(30.0, 30.0, 30.0)),
            dict(d_rgb=(0.6, 0.45, 0.3)),
            dict(kind='METAL', g_rgb=(1.0, 1.0, 1.0), roughness=0.3)]
    z0, s = -0.5, 6.0
    ground = np.array([[[-s, -s, z0], [s, -s, z0], [s, s, z0]],
                       [[-s, -s, z0], [s, s, z0], [-s, s, z0]]], np.float32)
    light = np.array([[[-1, -1, 5], [1, 1, 5], [1, -1, 5]],
                      [[-1, -1, 5], [-1, 1, 5], [1, 1, 5]]], np.float32)
    sh = np.where(g.uniform(size=len(ribbon)) < 0.25, 3, 2).astype(np.int32)
    # 180 degrees about y: the camera looks down -z
    cam = dict(pos=np.array([0, 0, 3], np.float32),
               pos_t1=np.array([0, 0, 3], np.float32),
               orient=np.array([0, 0, 1, 0], np.float32),
               orient_t1=np.array([0, 0, 1, 0], np.float32), focus=3.0,
               focal_length=0.24)
    return (np.concatenate([ribbon, ground, light]),
            np.concatenate([sh, np.array([0, 0, 1, 1], np.int32)]), mats,
            cam, dict(sky_rgb=(1.0, 1.0, 1.0)))
