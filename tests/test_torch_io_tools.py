"""The port's file writers and tools against the JAX package's: the bytes of
every writer equal the JAX writer's for the same numpy inputs and read back
through the port's readers; the tools pass twins of tests/test_io_tools.py."""

import dataclasses
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from corona13_tpu.io import cam as jcam
from corona13_tpu.io import geo as jgeo
from corona13_tpu.io import vol as jvol
from corona13_tpu.tools import netdisplay as jnetdisplay
from corona13_tpu_torch.io import cam as tcam
from corona13_tpu_torch.io import fb as fb_io
from corona13_tpu_torch.io import geo as tgeo
from corona13_tpu_torch.io import pfm as pfm_io
from corona13_tpu_torch.io import vol as tvol
from corona13_tpu_torch.tools import netdisplay, obj2geo, pfmdiff, welch


def _same_bytes(tmp_path, name, jwrite, twrite, *args, **kw):
    a, b = str(tmp_path / f'{name}_t'), str(tmp_path / f'{name}_j')
    twrite(a, *args, **kw)
    jwrite(b, *args, **kw)
    data = open(a, 'rb').read()
    assert data == open(b, 'rb').read(), name
    return a


def test_write_cam_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    q = r.normal(size=4).astype(np.float32)
    c = tcam.CameraData(
        pos=r.uniform(-5, 5, 3).astype(np.float32),
        pos_t1=r.uniform(-5, 5, 3).astype(np.float32),
        orient=q / np.linalg.norm(q), orient_t1=np.array([1, 0, 0, 0],
                                                        np.float32),
        focus=7.5, focal_length=0.5, film_width=0.36, film_height=0.24,
        crop_factor=1.5, aperture_value=3, exposure_value=9, iso=400.0,
        speed=0.25, focus_sensor_offset=0.01)
    path = _same_bytes(tmp_path, 'c.cam', jcam.write_cam, tcam.write_cam, c)
    back = tcam.read_cam(path)
    for f in dataclasses.fields(tcam.CameraData):
        np.testing.assert_allclose(getattr(back, f.name), getattr(c, f.name),
                                   rtol=1e-7, err_msg=f.name)


def _mesh(n, seed):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-3, 3, (n, 1, 3))
    tri = (v0 + r.uniform(-1, 1, (n, 3, 3))).astype(np.float32)
    ns = r.normal(size=(n, 3, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    uv = r.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    return tri, ns, uv


@pytest.mark.parametrize('case', ['static', 'normals_uv', 'moving'])
def test_save_geo_matches_jax(tmp_path, case):
    """save_geo: face normals, given normals and uvs, and the motion layout
    (bit 60 set, t0/t1 vertices interleaved at stride 2)."""
    tri, ns, uv = _mesh(9, 1)
    kw = {'static': {}, 'normals_uv': dict(tri_ns=ns, tri_uv=uv),
          'moving': dict(tri_vtx_t1=tri + np.float32(0.5))}[case]
    path = _same_bytes(tmp_path, 'm.geo', jgeo.save_geo, tgeo.save_geo, tri,
                       **kw)
    g = tgeo.load_geo(path)
    np.testing.assert_array_equal(g.tri_vtx, tri)
    assert g.has_motion == (case == 'moving')
    if case == 'moving':
        np.testing.assert_array_equal(g.tri_vtx_t1, tri + np.float32(0.5))
    if case == 'normals_uv':
        assert np.abs((g.tri_ns * ns).sum(-1) - 1).max() < 1e-3
        np.testing.assert_allclose(g.tri_uv, uv, atol=1e-3)


@pytest.mark.parametrize('with_uv', [False, True])
def test_write_geo_matches_jax(tmp_path, with_uv):
    """write_geo (obj2geo's output stage) never sets the motion bit."""
    tri, ns, uv = _mesh(7, 2)
    kw = dict(tri_ns=ns, tri_uv=uv) if with_uv else {}
    path = _same_bytes(tmp_path, 'w.geo', jgeo.write_geo, tgeo.write_geo, tri,
                       **kw)
    g = tgeo.load_geo(path)
    np.testing.assert_array_equal(g.tri_vtx, tri)
    assert not g.has_motion
    if with_uv:
        np.testing.assert_allclose(g.tri_uv, uv, atol=1e-3)
        np.testing.assert_array_equal(
            tgeo.decode_uv(tgeo.encode_uv(uv.reshape(-1, 2))),
            jgeo.decode_uv(jgeo.encode_uv(uv.reshape(-1, 2))))


def test_encode_uv_matches_jax():
    uv = np.random.default_rng(3).uniform(-2, 2, (5, 7, 2)).astype(np.float32)
    a, b = tgeo.encode_uv(uv), jgeo.encode_uv(uv)
    assert a.dtype == b.dtype == np.uint32 and a.shape == (5, 7)
    np.testing.assert_array_equal(a, b)


def _grid(res, seed):
    r = np.random.default_rng(seed)
    d = r.uniform(0, 1, (res, res, res)).astype(np.float32)
    d[d < 0.6] = 0.0            # empty bricks
    d[: res // 2, :, : res // 2] = 0.0
    t = (r.uniform(0, 1500, d.shape) * (d > 0)).astype(np.float32)
    return d, t


@pytest.mark.parametrize('case', ['64', '32_resampled', 'cubic_aabb'])
def test_write_vol_matches_jax(tmp_path, case):
    """write_vol at 64^3, a 32^3 grid resampled to 64^3 by nearest
    sampling, and an explicit cubic aabb; read back by the port's reader."""
    res = 32 if case == '32_resampled' else 64
    d, t = _grid(res, 4)
    kw = dict(aabb=[1, 2, 3, 9, 10, 11], loc=(0.5, 0, 0), rot=(0, 0.3, 0),
              shaderid=2) if case == 'cubic_aabb' else dict(voxel_size=0.5)
    path = _same_bytes(tmp_path, 'v.vol', jvol.write_vol, tvol.write_vol, d, t,
                       **kw)
    v = tvol.read_vol(path)
    up = d if res == 64 else d.repeat(2, 0).repeat(2, 1).repeat(2, 2)
    np.testing.assert_allclose(v.density, up, rtol=1e-3, atol=1e-3)
    if case == 'cubic_aabb':
        np.testing.assert_allclose(v.aabb, [1, 2, 3, 9, 10, 11])
        assert abs(float(v.voxel_size) - 8 / 64) < 1e-7
        assert v.shaderid == 2


def test_write_vol_refuses(tmp_path):
    d, _ = _grid(64, 5)
    for mod in (tvol, jvol):
        with pytest.raises(ValueError, match='write_vol needs a cubic aabb'):
            mod.write_vol(str(tmp_path / 'x.vol'), d, aabb=[0, 0, 0, 1, 2, 1])
        with pytest.raises(ValueError, match='shape mismatch'):
            mod.write_vol(str(tmp_path / 'x.vol'), d, d[:32])


def test_pfmdiff_tool(tmp_path):
    a = np.random.default_rng(0).uniform(0, 1, (6, 8, 3)).astype(np.float32)
    pa = str(tmp_path / 'a.pfm')
    pb = str(tmp_path / 'b.pfm')
    pfm_io.write_pfm(pa, a)
    pfm_io.write_pfm(pb, a + 0.01)
    assert pfmdiff.main([pa, pb, '--max-error', '0.02']) == 0
    assert pfmdiff.main([pa, pb, '--max-error', '0.005']) == 1
    pd = str(tmp_path / 'd.pfm')
    assert pfmdiff.main([pa, pb, '--diff', pd]) == 0
    np.testing.assert_allclose(pfm_io.read_pfm(pd), 0.01, atol=1e-6)
    pfm_io.write_pfm(pb, a[:5])
    assert pfmdiff.main([pa, pb]) == 2


def test_welch_tool(tmp_path):
    rngs = np.random.default_rng(1)
    base = rngs.uniform(0.4, 0.6, (64, 64, 3)).astype(np.float32)
    pa = str(tmp_path / 'a.pfm')
    pb = str(tmp_path / 'b.pfm')
    pc = str(tmp_path / 'c.pfm')
    pfm_io.write_pfm(pa, base)
    pfm_io.write_pfm(pb, base + rngs.normal(0, 0.001, base.shape).astype(
        np.float32))
    pfm_io.write_pfm(pc, base + 0.5)
    assert welch.main([pa, pb]) == 0     # same distribution
    assert welch.main([pa, pc]) == 1     # significantly different


_CUBE = ['v -1 -1 -1', 'v 1 -1 -1', 'v 1 1 -1', 'v -1 1 -1',
         'v -1 -1 1', 'v 1 -1 1', 'v 1 1 1', 'v -1 1 1',
         'f 1 2 3 4', 'f 5 8 7 6', 'f 1 5 6 2',
         'f 2 6 7 3', 'f 3 7 8 4', 'f 4 8 5 1']


def test_obj2geo_round_trip(tmp_path):
    obj = tmp_path / 'c.obj'
    obj.write_text('\n'.join(_CUBE))
    out = str(tmp_path / 'c.geo')
    assert obj2geo.main([str(obj), out]) == 0
    g = tgeo.load_geo(out)
    assert len(g.tri_vtx) == 12
    assert abs(g.tri_vtx.min() + 1) < 1e-5 and abs(g.tri_vtx.max() - 1) < 1e-5
    gn = np.cross(g.tri_vtx[:, 1] - g.tri_vtx[:, 0],
                  g.tri_vtx[:, 2] - g.tri_vtx[:, 0])
    gn /= np.linalg.norm(gn, axis=-1, keepdims=True)
    assert np.abs((g.tri_ns * gn[:, None, :]).sum(-1) - 1).max() < 1e-3


def test_obj2geo_module_matches_jax(tmp_path):
    """``python -m corona13_tpu_torch.tools.obj2geo`` on an OBJ with
    normals, uvs and negative indices writes the JAX tool's bytes."""
    from corona13_tpu.tools import obj2geo as jobj2geo
    obj = tmp_path / 'n.obj'
    obj.write_text('\n'.join(
        ['v 0 0 0', 'v 1 0 0', 'v 1 1 0', 'v 0 1 0', 'vn 0 0 1',
         'vt 0 0', 'vt 1 0', 'vt 1 1', 'vt 0 1', '# a quad',
         'f 1/1/1 2/2/1 3/3/1 4/4/1', 'f -4/-4/-1 -2/-2/-1 -1/-1/-1']))
    out = tmp_path / 'n.geo'
    run = subprocess.run([sys.executable, '-m',
                          'corona13_tpu_torch.tools.obj2geo', str(obj),
                          str(out)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert '3 triangles +normals +uvs' in run.stdout
    assert jobj2geo.main([str(obj), str(tmp_path / 'j.geo')]) == 0
    assert out.read_bytes() == (tmp_path / 'j.geo').read_bytes()


def test_netdisplay_tonemap_matches_jax():
    img = np.random.default_rng(4).uniform(0, 2, (12, 16, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(netdisplay._tonemap(img, 1.3),
                                  jnetdisplay._tonemap(img, 1.3))


def test_netdisplay_serves_frames(tmp_path):
    """MJPEG net display: watches a .fb file and serves JPEG frames over
    HTTP on a local socket."""
    path = str(tmp_path / 'live.fb')
    f = fb_io.Framebuffer.open(path, 16, 12, retain=False)
    img = np.random.default_rng(0).uniform(0, 1, (12, 16, 3)).astype(
        np.float32)
    f.accumulate(img, 1)
    f.flush(iso=100.0)
    httpd, watcher = netdisplay.serve(path, port=0, fps=20.0,
                                      run_forever=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for _ in range(100):
            if watcher.frame:
                break
            time.sleep(0.05)
        assert watcher.spp == 1
        port = httpd.server_address[1]
        data = urllib.request.urlopen(
            f'http://127.0.0.1:{port}/frame.jpg', timeout=5).read()
        assert data[:2] == b'\xff\xd8'  # JPEG SOI marker
    finally:
        httpd.shutdown()
        httpd.server_close()
        watcher.stop()
