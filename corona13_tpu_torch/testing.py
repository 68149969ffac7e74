"""Procedural test scenes (corona13_tpu/testing.py), built on the device.

The same arrays, BVH (``corona13_tpu.ops.bvh``), spectral fits and light
CDF as the JAX package's scenes, so a scene built here equals the
converted JAX one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import scene as scene_mod
from .io import cam as cam_io
from .io import geo as geo_io
from .ops.trace import make_device_geometry

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'data')


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for the quad p0-p1-p2-p3."""
    return np.array([[p0, p1, p2], [p0, p2, p3]], np.float32)


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
        kinds_used=tuple(sorted({m.kind for m in mats})),
        has_media=any(m.med_enabled for m in mats))


def cornell_scene(sphere: str | None = 'diffuse', light=40.0,
                  albedo=(0.7, 0.7, 0.7), device='cuda') -> scene_mod.Scene:
    """Cornell-style box, 10 units wide, centered 15 units down +z from the
    camera at the origin.  ``sphere``: None | 'diffuse' | 'dielectric' |
    'rough_dielectric' | 'metal' | 'mirror' | 'subsurf' (dielectric shell
    with a scattering interior) | 'absorb' (purely absorbing interior)."""
    s = 5.0    # half box width
    z0, z1 = 10.0, 20.0
    tris = []
    shs = []

    def add(quad, sh):
        tris.append(quad)
        shs.extend([sh, sh])

    # material ids: 0 white, 1 red, 2 green, 3 light, 4 sphere
    add(_quad((-s, -s, z0), (s, -s, z0), (s, -s, z1), (-s, -s, z1)), 0)
    add(_quad((-s, s, z0), (-s, s, z1), (s, s, z1), (s, s, z0)), 0)
    add(_quad((-s, -s, z1), (s, -s, z1), (s, s, z1), (-s, s, z1)), 0)
    add(_quad((-s, -s, z0), (-s, -s, z1), (-s, s, z1), (-s, s, z0)), 1)
    add(_quad((s, -s, z0), (s, s, z0), (s, s, z1), (s, -s, z1)), 2)
    ls = 1.5
    zl = 0.5 * (z0 + z1)
    add(_quad((-ls, s - 0.01, zl - ls), (ls, s - 0.01, zl - ls),
              (ls, s - 0.01, zl + ls), (-ls, s - 0.01, zl + ls)), 3)
    tri_v = np.concatenate(tris)
    # light winding: normal -y
    gn = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    for i, sh in enumerate(shs):
        if sh == 3 and gn[i, 1] > 0:
            tri_v[i] = tri_v[i, ::-1]

    M = scene_mod._ResolvedMat
    mats = [M(d_rgb=tuple(albedo)), M(d_rgb=(0.6, 0.1, 0.1)),
            M(d_rgb=(0.1, 0.6, 0.1)), M(e_rgb=(light, light, light))]
    sph_c = sph_r = sph_sh = None
    if sphere is not None:
        sph_c = np.array([[0.0, -s + 2.0, 15.0]], np.float32)
        sph_r = np.array([2.0], np.float32)
        sph_sh = np.array([4], np.int32)
        spheres = {
            'diffuse': M(d_rgb=(0.6, 0.5, 0.3)),
            'dielectric': M(kind=scene_mod.DIELECTRIC, g_rgb=(1, 1, 1),
                            roughness=0.0, ior_nd=1.5, ior_abbe=40.0),
            'rough_dielectric': M(kind=scene_mod.DIELECTRIC, g_rgb=(1, 1, 1),
                                  roughness=0.3, ior_nd=1.5, ior_abbe=40.0),
            'metal': M(kind=scene_mod.METAL, g_rgb=(0.9, 0.9, 0.9),
                       roughness=0.2),
            'mirror': M(kind=scene_mod.METAL, g_rgb=(1, 1, 1), roughness=0.0),
            'subsurf': M(kind=scene_mod.DIELECTRIC, g_rgb=(1, 1, 1),
                         roughness=0.0, ior_nd=1.3, ior_abbe=40.0,
                         med_mfp_rgb=(0.5, 0.7, 0.9),
                         med_albedo_rgb=(0.95, 0.9, 0.85), med_g=0.3,
                         med_enabled=True),
            'absorb': M(kind=scene_mod.DIELECTRIC, g_rgb=(1, 1, 1),
                        roughness=0.0, ior_nd=1.3, ior_abbe=40.0,
                        med_mfp_rgb=(1.0, 1.0, 1.0),
                        med_albedo_rgb=(0.0, 0.0, 0.0), med_enabled=True),
        }
        if sphere not in spheres:
            raise ValueError(sphere)
        mats.append(spheres[sphere])
    cam = cam_io.CameraData(
        pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
        orient=np.array([1, 0, 0, 0], np.float32),
        orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    return assemble_scene(tri_v, np.asarray(shs), mats, cam, sph_c=sph_c,
                          sph_r=sph_r, sph_sh=sph_sh, device=device)


def furnace_scene(albedo=0.5, emission=1.0, sphere=True,
                  device='cuda') -> scene_mod.Scene:
    """White furnace: constant sky + a diffuse sphere (one faraway dummy
    triangle keeps the triangle BVH non-degenerate)."""
    M = scene_mod._ResolvedMat
    mats = [M(d_rgb=(albedo, albedo, albedo))]
    if sphere:
        sph_c = np.array([[0.0, 0.0, 15.0]], np.float32)
        sph_r = np.array([4.0], np.float32)
        sph_sh = np.array([0], np.int32)
    else:
        sph_c = sph_r = sph_sh = None
    cam = cam_io.CameraData(
        pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
        orient=np.array([1, 0, 0, 0], np.float32),
        orient_t1=np.array([1, 0, 0, 0], np.float32), focus=15.0)
    tri_v = np.array([[[1e4, 1e4, 1e4], [1e4 + 1, 1e4, 1e4],
                       [1e4, 1e4 + 1, 1e4]]], np.float32)
    return assemble_scene(tri_v, np.array([0], np.int32), mats, cam,
                          sky_rgb=(emission, emission, emission),
                          sph_c=sph_c, sph_r=sph_r, sph_sh=sph_sh,
                          device=device)


def plane_scene_inputs():
    """Inputs of the in-repo 8198-triangle scene: ``0002_mb`` without its
    moving cube (``data/golden/scenes/0002_mb/test.nra2``): ``plane.geo``
    as grey diffuse (0.3), ``emitter.geo`` emitting 200, and the scene's
    ``test01.cam``.  Returns (tri_v, tri_sh, mats, cam) for
    ``assemble_scene`` of either package."""
    geo_dir = os.path.join(_DATA, 'golden', 'scenes', 'geo')
    plane = geo_io.load_geo(os.path.join(geo_dir, 'plane.geo')).tri_vtx
    light = geo_io.load_geo(os.path.join(geo_dir, 'emitter.geo')).tri_vtx
    tri_v = np.concatenate([plane, light])
    tri_sh = np.concatenate([np.zeros(len(plane), np.int32),
                             np.ones(len(light), np.int32)])
    M = scene_mod._ResolvedMat
    mats = [M(d_rgb=(0.3, 0.3, 0.3)), M(e_rgb=(200.0, 200.0, 200.0))]
    cam = cam_io.read_cam(os.path.join(_DATA, 'golden', 'scenes', '0002_mb',
                                       'test01.cam'))
    return tri_v, tri_sh, mats, cam


def plane_scene(device='cuda') -> scene_mod.Scene:
    """The 8198-triangle scene of ``plane_scene_inputs`` on ``device``."""
    return assemble_scene(*plane_scene_inputs(), device=device)
