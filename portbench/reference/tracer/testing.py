# Frozen copy of corona13_tpu_torch/testing.py assemble_scene (lines 29-87) as of commit 2084081, for the benchmark's plain reference.
"""Scene assembly from triangle soup and resolved materials."""

from __future__ import annotations

import numpy as np
import torch

from . import scene as scene_mod
from .io import cam as cam_io
from .ops.trace import make_device_geometry


def assemble_scene(tri_v, tri_sh, mats, cam: cam_io.CameraData,
                   sky_rgb=(0.0, 0.0, 0.0), sph_c=None, sph_r=None,
                   sph_sh=None, line_vtx=None, line_radii=None,
                   line_sh=None, device='cuda') -> scene_mod.Scene:
    """Build a Scene on ``device`` (the card unless ``device='cpu'`` is
    passed) from triangle soup + resolved materials.

    tri_v: [T, 3, 3]; tri_sh: [T] material ids; mats: list of
    scene._ResolvedMat (same light-CDF and spectral-fit semantics as the
    JAX package's scene assembly)."""
    tri_v = np.asarray(tri_v, np.float32)
    tri_sh = np.asarray(tri_sh, np.int32)
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    tri_n = np.repeat(gn[:, None, :], 3, axis=1)
    sph_c = (np.zeros((0, 3), np.float32) if sph_c is None
             else np.asarray(sph_c, np.float32))
    sph_r = (np.zeros((0,), np.float32) if sph_r is None
             else np.asarray(sph_r, np.float32))
    sph_sh = (np.zeros((0,), np.int32) if sph_sh is None
              else np.asarray(sph_sh, np.int32))
    line_vtx = (np.zeros((0, 2, 3), np.float32) if line_vtx is None
                else np.asarray(line_vtx, np.float32))
    line_radii = (np.zeros((0, 2), np.float32) if line_radii is None
                  else np.asarray(line_radii, np.float32))
    line_sh = (np.zeros((0,), np.int32) if line_sh is None
               else np.asarray(line_sh, np.int32))
    geom = make_device_geometry(tri_v=tri_v, tri_vn=tri_n, tri_shader=tri_sh,
                                sph_c=sph_c, sph_r=sph_r, sph_shader=sph_sh,
                                line_vtx=line_vtx, line_radii=line_radii,
                                line_shader=line_sh, device=device)
    prim_shader = np.concatenate([tri_sh, sph_sh, line_sh])

    materials = scene_mod.material_table(mats, np.full(len(mats), -1),
                                         device=device)
    lights = scene_mod.light_table(tri_v, tri_sh, len(prim_shader),
                                   materials)
    t = lambda a, dtype=None: scene_mod._tensor(a, device, dtype)
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=device)
    camera = scene_mod.CameraP(
        pos=t(cam.pos, np.float32), pos_t1=t(cam.pos_t1, np.float32),
        orient=t(cam.orient, np.float32),
        orient_t1=t(cam.orient_t1, np.float32),
        focus=f32(cam.focus), focal_length=f32(cam.focal_length),
        film_width=f32(cam.film_width), film_height=f32(cam.film_height),
        f_stop=f32(cam.f_stop), exposure_time=f32(cam.exposure_time),
        iso=f32(cam.iso))

    sky_rgb = np.asarray(sky_rgb, np.float32)
    sc, sm = scene_mod._fit(sky_rgb[None])
    sky_kind = scene_mod.SKY_CONST if sky_rgb.max() > 0 else scene_mod.SKY_BLACK
    return scene_mod.Scene(
        geom=geom, materials=materials, lights=lights, camera=camera,
        prim_shader=t(prim_shader, np.int64),
        sky_kind=torch.tensor(sky_kind, dtype=torch.int64, device=device),
        sky_coeff=t(sc[0]), sky_mul=f32(sm[0]),
        kinds_used=tuple(sorted({m.kind for m in mats})))
