"""Every prim kind of the port against the JAX package, on the CPU.

Motion-blurred triangles, sphere and line BVHs, the dense small lists,
line shading, image textures and the HAIR scene: the same inputs (numpy,
from a seed) go through ``corona13_tpu`` (pinned to the CPU, where it runs
XLA's skip-link ``_traverse``) and through the port's plain versions
(``ops/trace_plain.py``), on geometry converted from the JAX one, so both
walk the same trees.

Tolerances.  Candidate intersectors: masks equal on >= 99.9% of the
candidates (a root at a tangent or at a cap flips on the last ulp: XLA
fuses multiply-adds that torch rounds twice), t and the axial fraction
within rtol 1e-5 / atol 1e-5 where both hit.  ``intersect`` / ``occluded``:
prim and blocked equal on >= 99.9% of rays, t within rtol 1e-5 / atol 1e-5
where prim agrees (coordinates of magnitude 10 cancel in the lerp and the
edge products; on scenes with lines, whose cone quadratic cancels in
b*b - 4ac, t within rtol 1e-4 and the axial fraction u within 1e-3); the
rest are exact-t ties.  Paths: ``accum`` within rtol 1e-4 /
atol 1e-6 on >= 99% of paths, as tests/test_torch_render.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu import scene as jscene
from corona13_tpu import testing as jtesting
from corona13_tpu.io import cam as jcam
from corona13_tpu.io import geo as jgeo
from corona13_tpu.io import pfm as jpfm
from corona13_tpu.models import bsdf as jbsdf
from corona13_tpu.models import shading as jshading
from corona13_tpu.ops import trace as jtrace
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import convert
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import testing as ttesting
from corona13_tpu_torch.io import geo as tgeo
from corona13_tpu_torch.models import shading as tshading
from corona13_tpu_torch.ops import trace as ttrace
from corona13_tpu_torch.ops import trace_plain
from corona13_tpu_torch.samplers import pt as pt_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'data', 'golden')
J, T = jnp.asarray, torch.as_tensor


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process (the suite runs in xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(a, b):
    """Equal tensors, floats by their bits (a BVH's int columns are NaN
    patterns when read as floats)."""
    view = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    return a.shape == b.shape and torch.equal(view(a), view(b))


def _rays(n, seed, box=12.0):
    g = np.random.default_rng(seed)
    org = g.uniform(-box, box, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


def _tris(n, g):
    v0 = g.uniform(-10, 10, (n, 3)).astype(np.float32)
    e = g.uniform(-3.0, 3.0, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def _spheres(n, g):
    return dict(sph_c=g.uniform(-10, 10, (n, 3)).astype(np.float32),
                sph_r=g.uniform(0.3, 1.5, n).astype(np.float32))


def _lines(n, g):
    a = g.uniform(-10, 10, (n, 3)).astype(np.float32)
    b = a + g.uniform(-3, 3, (n, 3)).astype(np.float32)
    return dict(line_vtx=np.stack([a, b], axis=1),
                line_radii=g.uniform(0.1, 0.6, (n, 2)).astype(np.float32))


# --- candidate intersectors --------------------------------------------------

def _masks_and_values(jout, tout):
    jok, tok = np.asarray(jout[-1]), tout[-1].numpy()
    assert jok.any() and (jok == tok).mean() >= 0.999
    both = jok & tok
    for j, t in zip(jout[:-1], tout[:-1]):
        np.testing.assert_allclose(t.numpy()[both], np.asarray(j)[both],
                                   rtol=1e-5, atol=1e-5)


def test_ray_cone_intersect_matches_jax():
    g = np.random.default_rng(40)
    k = 24
    ln = _lines(k, g)
    v0, v1 = ln['line_vtx'][None, :, 0], ln['line_vtx'][None, :, 1]
    r0, r1 = ln['line_radii'][None, :, 0], ln['line_radii'][None, :, 1]
    org, d = _rays(3000, 41)
    _masks_and_values(
        jtrace.ray_cone_intersect(J(v0), J(v1), J(r0), J(r1), J(org), J(d)),
        ttrace.ray_cone_intersect(T(v0), T(v1), T(r0), T(r1), T(org), T(d)))


def test_ray_sphere_intersect_matches_jax():
    s = _spheres(24, np.random.default_rng(42))
    org, d = _rays(3000, 43)
    _masks_and_values(
        jtrace.ray_sphere_intersect(J(s['sph_c'][None]), J(s['sph_r'][None]),
                                    J(org), J(d)),
        ttrace.ray_sphere_intersect(T(s['sph_c'][None]), T(s['sph_r'][None]),
                                    T(org), T(d)))


def test_lerped_triangle_test_matches_jax():
    """rows*(1-w) + rows1*w at a per-ray time, then Moeller-Trumbore."""
    g = np.random.default_rng(44)
    tri = _tris(24, g)
    tri1 = tri + g.uniform(-1, 1, (24, 1, 3)).astype(np.float32)
    pack = lambda v: np.concatenate([v[:, 0], v[:, 1] - v[:, 0],
                                     v[:, 2] - v[:, 0]], axis=1)[None]
    org, d = _rays(3000, 45)
    w = g.uniform(0, 1, 3000).astype(np.float32)
    jw = J(w)[:, None, None]
    jrows = J(pack(tri)) * (1.0 - jw) + J(pack(tri1)) * jw
    trows = trace_plain.lerp_rows(T(pack(tri)), T(pack(tri1)),
                                  T(w)[:, None, None])
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=1e-6,
                               atol=1e-6)
    _masks_and_values(
        jtrace.ray_tri_intersect_packed(jrows, J(org), J(d)),
        ttrace.ray_tri_intersect_packed(trows, T(org), T(d)))


# --- intersect / occluded on every kind ---------------------------------------

def _geometry(case):
    g = np.random.default_rng(50)
    if case == 'moving300':
        tri = _tris(300, g)
        return dict(tri_v=tri, tri_v_t1=tri + g.uniform(
            -1.5, 1.5, (300, 1, 3)).astype(np.float32))
    if case == 'spheres200':
        return _spheres(200, g)
    if case == 'lines200':
        return _lines(200, g)
    if case == 'lines40':
        return _lines(40, g)
    tri = _tris(150, g)
    return dict(tri_v=tri, tri_v_t1=tri + g.uniform(
        -1.5, 1.5, (150, 1, 3)).astype(np.float32), **_spheres(100, g),
        **_lines(100, g))


@pytest.mark.parametrize('case', ['moving300', 'spheres200', 'lines200',
                                  'lines40', 'mixed'])
def test_intersect_and_occluded_match_jax(case):
    """Closest hit and shadow test of one geometry in both packages, with
    ray times, dead lanes (t_max = 0), bounded segments and the first
    hit's prim excluded through either ignore slot."""
    jg = jtrace.make_device_geometry(**_geometry(case))
    tg = convert.scene_from_numpy(jg, device='cpu')
    n = 2500
    org, d = _rays(n, 51)
    time = np.random.default_rng(52).uniform(0, 1, n).astype(np.float32)
    t_max = np.full(n, 3.0e38, np.float32)
    t_max[::4] = 10.0
    t_max[:25] = 0.0
    first = np.asarray(jtrace.intersect(jg, J(org), J(d), time=J(time)).prim)
    lane = np.arange(n)
    ig = np.where(lane % 3 == 1, first, -1).astype(np.int32)
    ig2 = np.where(lane % 3 == 2, first, -1).astype(np.int32)
    jh = jtrace.intersect(jg, J(org), J(d), ignore_prim=J(ig), t_max=J(t_max),
                          time=J(time))
    th = ttrace.intersect(tg, T(org), T(d), ignore_prim=T(ig).long(),
                          t_max=T(t_max), time=T(time))
    jp, tp = np.asarray(jh.prim), th.prim.numpy()
    assert (jp >= 0).mean() > 0.03 and (tp[:25] == -1).all()
    assert (tp == jp).mean() >= 0.999
    same = (tp == jp) & (jp >= 0)
    # a cone's quadratic cancels in b*b - 4ac on thin fibres: t to 1e-4
    # there, and the axial fraction, which divides that error by a fibre's
    # length, to 1e-3
    lines = 'line_vtx' in _geometry(case)
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-4 if lines else 1e-5, atol=1e-5)
    for name in ('u', 'v'):
        np.testing.assert_allclose(getattr(th, name).numpy()[same],
                                   np.asarray(getattr(jh, name))[same],
                                   atol=1e-3 if lines else 1e-5)
    np.testing.assert_array_equal(th.slot.numpy()[same],
                                  np.asarray(jh.slot)[same])
    if case == 'mixed':         # every kind wins somewhere
        for lo, hi in ((0, 150), (150, 250), (250, 350)):
            assert ((tp >= lo) & (tp < hi)).any()
    seg = np.where(lane % 2 == 0, 6.0, 14.0).astype(np.float32)
    seg[:25] = 0.0
    jb = jtrace.occluded(jg, J(org), J(d), J(seg), ignore_prim=J(ig),
                         ignore_prim2=J(ig2), time=J(time))
    tb = ttrace.occluded(tg, T(org), T(d), T(seg), ignore_prim=T(ig).long(),
                         ignore_prim2=T(ig2).long(), time=T(time))
    assert np.asarray(jb).any() and not tb[:25].any()
    assert (tb.numpy() == np.asarray(jb)).mean() >= 0.999


def test_static_call_ignores_time_and_uploads_every_kind():
    """time on a static scene is ignored; sphere and line BVHs above the
    dense limit get the wide layout and the kernel's rows, shorter lists
    and empty kinds only what the dense form reads."""
    g = np.random.default_rng(53)
    tg = ttrace.make_device_geometry(tri_v=_tris(50, g), **_spheres(70, g),
                                     **_lines(30, g), device='cpu')
    org, d = (T(x) for x in _rays(400, 54))
    a = ttrace.intersect(tg, org, d)
    b = ttrace.intersect(tg, org, d, time=torch.rand(400))
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    for bvh, row in ((tg.tri_bvh, 12), (tg.sph_bvh, 4), (tg.line_bvh, 12)):
        assert bvh.knodes.shape[1:] == (8, 8) and bvh.stack_depth > 0
        assert bvh.kleaves.shape[1:] == (8, row) and bvh.kleaves_t1 is None
        if row == 4:    # spheres: (c, r); the ids stay in leaf_prims
            assert torch.equal(bvh.kleaves.reshape(-1, 4), bvh.leaf_data)
            continue
        ids = bvh.kleaves[:, :, 3].contiguous().view(torch.int32).reshape(-1)
        assert torch.equal(ids.long(), bvh.leaf_prims)
    empty = ttrace.make_device_geometry(tri_v=_tris(5, g), device='cpu')
    assert empty.sph_bvh.kleaves is None and empty.line_bvh.knodes is None


# --- twins of tests/test_motion.py --------------------------------------------

def _moving_tri_geom():
    tri0 = np.array([[[-1, -1, 5], [0, -1, 5], [0, 1, 5]]], np.float32)
    tri1 = tri0 + np.array([1.5, 0, 0], np.float32)
    return ttrace.make_device_geometry(tri_v=tri0, tri_v_t1=tri1,
                                       device='cpu')


def test_time_resolved_triangle():
    g = _moving_tri_geom()
    org = torch.zeros(3, 3)
    org[:, 0] = torch.tensor([-0.5, -0.5, 1.2])
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(3, 1)
    tm = torch.tensor([0.0, 1.0, 1.0])
    # x=-0.5 visible at shutter open, gone at close; x=1.2 only at close
    assert ttrace.intersect(g, org, d, time=tm).valid.tolist() == \
        [True, False, True]
    # a call without time uses the shutter-open geometry
    assert ttrace.intersect(g, org, d).valid.tolist() == [True, True, False]
    # shadow rays share the semantics
    assert ttrace.occluded(g, org, d, torch.full((3,), 10.0),
                           time=tm).tolist() == [True, False, True]


def test_time_resolved_sphere():
    c0 = np.array([[0.0, 0.0, 5.0]], np.float32)
    c1 = np.array([[3.0, 0.0, 5.0]], np.float32)
    g = ttrace.make_device_geometry(sph_c=c0, sph_c_t1=c1,
                                    sph_r=np.array([1.0], np.float32),
                                    device='cpu')
    org = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(2, 1)
    tm = torch.tensor([0.0, 1.0])
    assert ttrace.intersect(g, org, d, time=tm).valid.tolist() == [True, False]
    assert ttrace.occluded(g, org, d, torch.full((2,), 10.0),
                           time=tm).tolist() == [True, False]


def test_geo_motion_roundtrip(tmp_path):
    """A .geo written with shutter-close vertices (the stride-2 layout)
    loads with both shutter states in the port."""
    tri0 = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[2, 0, 0], [3, 0, 0], [2, 1, 0]]], np.float32)
    tri1 = tri0 + np.array([0.5, 0.25, 0.0], np.float32)
    p = str(tmp_path / 'mb.geo')
    jgeo.save_geo(p, tri0, tri_vtx_t1=tri1)
    g = tgeo.load_geo(p)
    assert g.has_motion
    np.testing.assert_allclose(g.tri_vtx, tri0, atol=1e-6)
    np.testing.assert_allclose(g.tri_vtx_t1, tri1, atol=1e-6)


def _paths(js, ts, w, h, max_verts, mf, use_nee, sample=0):
    """Per-path accum of both packages at one sample index."""
    cfg_j = jpt.PTConfig(width=w, height=h, max_verts=max_verts, mf=mf,
                         use_nee=use_nee)
    cfg_t = pt_mod.PTConfig(width=w, height=h, max_verts=max_verts, mf=mf,
                            use_nee=use_nee)
    pix = np.arange(w * h, dtype=np.uint32)
    smp = np.full(w * h, sample, np.uint32)
    aj = jax.jit(lambda p, s: jpt.sample_paths(js, cfg_j, s, p)[0])(
        J(pix), J(smp))
    at = pt_mod.sample_paths(ts, cfg_t, T(smp.astype(np.int64)),
                             T(pix.astype(np.int64)))[0]
    return np.asarray(aj), at.numpy()


def _moving_cornell():
    """tests/test_motion.py:62-84: the cornell sphere displaced by two
    radii over a wide-open shutter; the sphere BVH stays the static one."""
    sc = jtesting.cornell_scene(sphere='diffuse')
    g = sc.geom.replace(sph_c_t1=sc.geom.sph_c + J([[4.0, 0.0, 0.0]]),
                        has_motion=True)
    return sc, sc.replace(geom=g, camera=sc.camera.replace(
        exposure_time=jnp.float32(1.0)))


def test_motion_blur_streak():
    """A sphere displaced over the shutter renders a streak in the port as
    in the JAX package: the moving scene's paths equal the JAX ones on
    >= 99% of paths and differ from the static scene's where it smears."""
    js, js_mb = _moving_cornell()
    ts_mb = convert.scene_from_numpy(js_mb, device='cpu')
    assert ts_mb.geom.has_motion and ts_mb.geom.sph_c_t1 is not None
    aj, at = _paths(js_mb, ts_mb, 48, 32, 3, 2, True)
    close = np.isclose(at, aj, rtol=1e-4, atol=1e-6).all(axis=-1)
    # reads 1.0000 with the port's correctly rounded root
    assert close.mean() >= 0.999, close.mean()
    cfg = pt_mod.PTConfig(width=48, height=32, max_verts=3, mf=2,
                          use_nee=True)
    ts = convert.scene_from_numpy(js, device='cpu')
    img_s = pt_mod.render_sample(ts, cfg, 0, batch=4).numpy()
    img_m = pt_mod.render_sample(ts_mb, cfg, 0, batch=4).numpy()
    assert np.isfinite(img_m).all()
    assert (np.abs(img_m - img_s).mean(axis=-1) > 1e-3).sum() > 20


# --- lines, HAIR, textures ------------------------------------------------------

def _hair_inputs(n_fibers=64):
    """The scene of tests/test_bsdf.py:225-257: HAIR fibres under a bright
    constant sky and one faraway dummy triangle."""
    M = jscene._ResolvedMat
    mats = [dict(kind=jbsdf.HAIR, d_rgb=(0.6, 0.4, 0.3), g_rgb=(0.3, 0.3, 0.3),
                 roughness=0.2)]
    g = np.random.default_rng(3)
    base = g.uniform(-2, 2, (n_fibers, 2))
    v0 = np.stack([base[:, 0], base[:, 1], np.full(n_fibers, 14.0)], -1)
    v1 = v0 + g.normal(0, 0.1, (n_fibers, 3)) + np.array([0, 3.0, 0])
    tri_v = np.array([[[1e4, 1e4, 1e4], [1e4 + 1, 1e4, 1e4],
                       [1e4, 1e4 + 1, 1e4]]], np.float32)
    cam = dict(pos=np.zeros(3, np.float32), pos_t1=np.zeros(3, np.float32),
               orient=np.array([1, 0, 0, 0], np.float32),
               orient_t1=np.array([1, 0, 0, 0], np.float32), focus=14.0)
    kw = dict(sky_rgb=(2.0, 2.0, 2.0),
              line_vtx=np.stack([v0, v1], axis=1).astype(np.float32),
              line_radii=np.full((n_fibers, 2), 0.06, np.float32),
              line_sh=np.zeros(n_fibers, np.int32))
    return tri_v, np.array([0], np.int32), mats, cam, kw, M


@pytest.mark.parametrize('n_fibers', [64, 90])
def test_hair_scene_paths_match_jax(n_fibers):
    """64 fibres take the dense list, 90 the line BVH; assemble_scene of
    the port with line arguments builds the scene the converted JAX one
    is."""
    from corona13_tpu_torch.io import cam as tcam
    tri_v, tri_sh, mats, cam, kw, M = _hair_inputs(n_fibers)
    js = jtesting.assemble_scene(tri_v, tri_sh, [M(**m) for m in mats],
                                 jcam.CameraData(**cam), **kw)
    ts = convert.scene_from_numpy(js, device='cpu')
    aj, at = _paths(js, ts, 32, 24, 4, 2, False)
    assert np.isfinite(at).all() and (aj > 0).any(axis=-1).mean() > 0.3
    close = np.isclose(at, aj, rtol=1e-4, atol=1e-6).all(axis=-1)
    # 64 fibres read 0.9987, 90 read 1.0000: the JAX package runs in this
    # process, where XLA contracts the cone quadratic's multiply-adds into
    # FMA (with XLA_FLAGS=--xla_cpu_max_isa=AVX both read 1.0000)
    assert close.mean() >= 0.99, close.mean()
    ps = ttesting.assemble_scene(
        tri_v, tri_sh, [tscene._ResolvedMat(**m) for m in mats],
        tcam.CameraData(**cam), device='cpu', **kw)
    assert ps.kinds_used == ts.kinds_used == (jbsdf.HAIR,)
    for name in ('line_v0', 'line_v1', 'line_r0', 'line_r1', 'line_shader'):
        assert torch.equal(getattr(ps.geom, name), getattr(ts.geom, name))
    for name in ('nodes', 'leaf_prims', 'leaf_data'):
        assert _same_bits(getattr(ps.geom.line_bvh, name),
                          getattr(ts.geom.line_bvh, name))
    assert torch.equal(ps.prim_shader, ts.prim_shader)
    ap = pt_mod.sample_paths(
        ps, pt_mod.PTConfig(width=32, height=24, max_verts=4, mf=2,
                            use_nee=False), 0, torch.arange(32 * 24))[0]
    np.testing.assert_allclose(ap.numpy(), at, rtol=1e-4, atol=1e-6)


def _shading_points_equal(jsp, tsp):
    for f in dataclasses.fields(tsp):
        j, t = getattr(jsp, f.name), getattr(tsp, f.name)
        if t.dtype in (torch.bool, torch.int64):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), f.name)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5, err_msg=f.name)


def _port_hit(hit):
    return ttrace.Hit(t=T(np.asarray(hit.t)),
                      prim=T(np.asarray(hit.prim)).long(),
                      u=T(np.asarray(hit.u)), v=T(np.asarray(hit.v)),
                      slot=T(np.asarray(hit.slot)).long())


def test_shading_prepare_on_line_hits():
    """Hits from the JAX traversal on a scene of lines, a sphere and
    triangles feed both shading ports: cone normals, the axial st, the
    fibre tangent and the material of each kind, elementwise (rtol 1e-5,
    atol 1e-5 on unit vectors that cancel towards 0)."""
    M = jscene._ResolvedMat
    g = np.random.default_rng(60)
    mats = [M(d_rgb=(0.5, 0.5, 0.5)),
            M(kind=jbsdf.HAIR, d_rgb=(0.6, 0.4, 0.3), g_rgb=(0.3, 0.3, 0.3),
              roughness=0.2), M(d_rgb=(0.2, 0.3, 0.7))]
    ln = _lines(80, g)
    js = jtesting.assemble_scene(
        _tris(40, g), np.zeros(40, np.int32), mats,
        jcam.CameraData(pos=np.zeros(3, np.float32),
                        pos_t1=np.zeros(3, np.float32),
                        orient=np.array([1, 0, 0, 0], np.float32),
                        orient_t1=np.array([1, 0, 0, 0], np.float32),
                        focus=14.0),
        sph_c=np.array([[0, 0, 0]], np.float32),
        sph_r=np.array([2.0], np.float32), sph_sh=np.array([2], np.int32),
        line_vtx=ln['line_vtx'], line_radii=ln['line_radii'],
        line_sh=np.ones(80, np.int32))
    ts = convert.scene_from_numpy(js, device='cpu')
    n = 3000
    org, d = _rays(n, 61)
    hit = jtrace.intersect(js.geom, J(org), J(d))
    prim = np.asarray(hit.prim)
    assert (prim >= 41).sum() > 100 and (prim == 40).any() and (prim < 0).any()
    x = np.asarray(J(org) + jnp.where(hit.valid, hit.t, 0.0)[:, None] * J(d))
    lam = (360.0 + 470.0 * np.random.default_rng(62).uniform(
        0, 1, (n, 4))).astype(np.float32)
    jsp = jshading.prepare(js, hit, J(x), J(d), J(lam))
    tsp = tshading.prepare(ts, _port_hit(hit), T(x), T(d), T(lam))
    _shading_points_equal(jsp, tsp)
    on_line = prim >= 41
    assert (tsp.kind.numpy()[on_line] == jbsdf.HAIR).all()
    assert np.abs(np.linalg.norm(tsp.tangent.numpy()[on_line], axis=-1)
                  - 1).max() < 1e-5


def _textured_scene(tmp_path):
    """tests/test_texture.py: one quad facing the camera, its diffuse
    slot a half red / half green .pfm."""
    img = np.zeros((16, 32, 3), np.float32)
    img[:, :16] = [0.8, 0.1, 0.1]
    img[:, 16:] = [0.1, 0.8, 0.1]
    jpfm.write_pfm(str(tmp_path / 'tex.pfm'), img)
    v = np.array([[[-5, -5, 10], [5, -5, 10], [5, 5, 10]],
                  [[-5, -5, 10], [5, 5, 10], [-5, 5, 10]]], np.float32)
    uv = np.array([[[0, 0], [1, 0], [1, 1]],
                   [[0, 0], [1, 1], [0, 1]]], np.float32)
    jgeo.write_geo(str(tmp_path / 'quad.geo'), v, tri_uv=uv)
    nra2 = tmp_path / 'test.nra2'
    nra2.write_text('black\n3\ndiffuse # 0\nmult 1 2 0 # 1\n'
                    'texture d tex.pfm # 2\n1\n1 quad\n')
    return str(nra2)


def test_texture_albedo_fetch(tmp_path):
    """The twin of tests/test_texture.py on the port, and the atlas and
    the shading of a textured material against the JAX package."""
    path = _textured_scene(tmp_path)
    sc, _ = tscene.load_scene(path, device='cpu')
    js, _ = jscene.load_scene(path)
    assert sc.has_textures and tuple(sc.tex_atlas.shape) == (1, 16, 32, 4)
    np.testing.assert_array_equal(sc.tex_dims.numpy(), np.asarray(js.tex_dims))
    # the atlas holds fitted coefficients: compare the spectra they give
    from corona13_tpu_torch.spectral import rgb2spec
    lam = torch.linspace(380, 730, 36)
    spec = lambda a: a[..., 3:4] * rgb2spec.eval_coeff(a[..., None, :3], lam)
    assert (spec(sc.tex_atlas) - spec(T(np.asarray(js.tex_atlas)))
            ).abs().max() < 1e-4
    n = 8
    xs = np.array([-2.5, 2.5, -2.5, 2.5, -1.0, 1.0, -3.0, 3.0], np.float32)
    org = np.stack([xs, np.zeros(n, np.float32), np.zeros(n, np.float32)], -1)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    hit = ttrace.intersect(sc.geom, T(org), T(d))
    assert bool(hit.valid.all())
    x = T(org) + hit.t[:, None] * T(d)
    rd_r = tshading.prepare(sc, hit, x, T(d), torch.full((n, 1), 620.0)
                            ).rd[:, 0].numpy()
    assert (rd_r[xs < 0] > 0.4).all()      # the red half reflects red
    assert (rd_r[xs > 0] < 0.3).all()      # the green half absorbs it
    # both packages on the converted scene, whose atlas is the JAX one
    ts = convert.scene_from_numpy(js, device='cpu')
    assert ts.has_textures and torch.equal(
        ts.tex_atlas, T(np.asarray(js.tex_atlas)))
    jhit = jtrace.intersect(js.geom, J(org), J(d))
    lam4 = np.tile(np.array([[450.0, 540.0, 620.0, 700.0]], np.float32),
                   (n, 1))
    _shading_points_equal(
        jshading.prepare(js, jhit, J(np.asarray(x)), J(d), J(lam4)),
        tshading.prepare(ts, _port_hit(jhit), x, T(d), T(lam4)))
    jsf = jscene.fit_film(js, 16, 12)
    aj, at = _paths(jsf, convert.scene_from_numpy(jsf, device='cpu'),
                    16, 12, 3, 4, True)
    np.testing.assert_allclose(at, aj, rtol=1e-4, atol=1e-6)


def test_convert_scene_with_lines_motion_and_texture(tmp_path):
    """A JAX scene with a texture atlas, line prims, a moving sphere and
    moving triangles converts without refusal: the JAX-side arrays are
    carried bit for bit, and the port's own wide layouts and kernel rows
    (which the JAX scene does not hold) come out as a fresh upload of the
    same host arrays gives them."""
    js, _ = jscene.load_scene(_textured_scene(tmp_path))
    g = np.random.default_rng(70)
    tri = _tris(120, g)
    geo = dict(tri_v=tri, tri_v_t1=tri + g.uniform(
        -1, 1, (120, 1, 3)).astype(np.float32), **_spheres(70, g),
        **_lines(90, g))
    geo['sph_c_t1'] = geo['sph_c'] + 0.5
    js = js.replace(geom=jtrace.make_device_geometry(**geo))
    ts = convert.scene_from_numpy(js, device='cpu')
    own = ttrace.make_device_geometry(**geo, device='cpu')
    assert ts.geom.has_motion and ts.has_textures
    assert torch.equal(ts.tex_atlas, T(np.asarray(js.tex_atlas)))
    for f in dataclasses.fields(ts.geom):
        a, b = getattr(ts.geom, f.name), getattr(own, f.name)
        if f.name.endswith('_bvh'):
            jb = getattr(js.geom, f.name)
            for k in dataclasses.fields(a):
                x, y = getattr(a, k.name), getattr(b, k.name)
                assert (x is None) == (y is None), f'{f.name}.{k.name}'
                if isinstance(x, torch.Tensor):
                    assert _same_bits(x, y), f'{f.name}.{k.name}'
                    if getattr(jb, k.name, None) is not None:
                        assert _same_bits(x, T(np.asarray(
                            getattr(jb, k.name))).to(x.dtype))
                else:
                    assert x == y
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert ts.geom.tri_bvh.kleaves_t1 is not None
    assert ts.geom.sph_bvh.knodes is not None      # 70 spheres: a wide tree
    org, d = (T(x) for x in _rays(500, 71))
    tm = torch.rand(500, generator=torch.Generator().manual_seed(1))
    a, b = (ttrace.intersect(x, org, d, time=tm) for x in (ts.geom, own))
    assert torch.equal(a.prim, b.prim) and (a.prim >= 240).any()


# --- the 0002_mb golden gate, the twin of tests/test_golden.py:235-253 -------

@pytest.mark.slow
def test_motion_blur_matches_reference():
    """0002_mb at the JAX test's settings and bounds."""
    from corona13_tpu_torch import render as render_mod
    from corona13_tpu_torch.io import pfm as tpfm
    sc, _ = tscene.load_scene(os.path.join(GOLDEN, 'scenes', '0002_mb',
                                           'test.nra2'), device='cpu')
    assert sc.geom.has_motion
    sc = tscene.fit_film(sc, 128, 80)
    cfg = pt_mod.PTConfig(width=128, height=80, max_verts=6, mf=4,
                          use_nee=True)
    res = render_mod.render(sc, cfg, spp=24, batch=8)
    g = tpfm.read_pfm(os.path.join(GOLDEN, '0002_mb.pfm'))
    h, w, c = g.shape
    gold = g.reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
    rmse = tpfm.rmse(res.image_xyz, gold)
    mean_rel = abs(res.image_xyz.mean() - gold.mean()) / gold.mean()
    assert rmse < 0.35, f'RMSE {rmse} vs reference gate 0.11@128spp'
    assert mean_rel < 0.05, f'mean energy off by {mean_rel:.1%}'
