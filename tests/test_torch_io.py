"""The port's host file readers and writer against the JAX package's:
decoded .geo shapes, cameras and PFM images identical, bit for bit."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from corona13_tpu.io import cam as jcam
from corona13_tpu.io import geo as jgeo
from corona13_tpu.io import pfm as jpfm
from corona13_tpu_torch.io import cam as tcam
from corona13_tpu_torch.io import geo as tgeo
from corona13_tpu_torch.io import pfm as tpfm

_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'data', 'golden', 'scenes')


@pytest.mark.parametrize('name', ['geo/plane.geo', 'geo/emitter.geo',
                                  '0031_hete/smokeproxy.geo'])
def test_load_tri_vtx_matches_jax(name):
    """Triangle positions (quads split in the reference loader's order)."""
    path = os.path.join(_SCENES, name)
    np.testing.assert_array_equal(tgeo.load_geo(path).tri_vtx,
                                  jgeo.load_geo(path).tri_vtx)


_GEOS = sorted(os.path.relpath(p, _SCENES) for p in
               glob.glob(os.path.join(_SCENES, '*', '*.geo')))


@pytest.mark.parametrize('name', _GEOS)
def test_load_geo_matches_jax(name):
    """Every field of the decoded shape: triangles and quad halves, oct
    normals, uvs, spheres, lines and the shutter-close (t1) motion data."""
    a = tgeo.load_geo(os.path.join(_SCENES, name))
    b = jgeo.load_geo(os.path.join(_SCENES, name))
    for f in dataclasses.fields(jgeo.GeoShape):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(x, y, f.name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


def test_geo_covers_spheres_and_motion():
    sph = tgeo.load_geo(os.path.join(_SCENES, 'geo', 'sphere.geo'))
    assert len(sph.sph_radius) == 1 and sph.sph_radius[0] == 1.0
    mb = tgeo.load_geo(os.path.join(_SCENES, 'geo', 'mbcube.geo'))
    assert mb.has_motion and not np.array_equal(mb.tri_vtx, mb.tri_vtx_t1)
    assert len(_GEOS) == 7


def test_read_cam_matches_jax():
    paths = sorted(glob.glob(os.path.join(_SCENES, '*', '*.cam')))
    assert paths
    for p in paths:
        a, b = tcam.read_cam(p), jcam.read_cam(p)
        for f in dataclasses.fields(jcam.CameraData):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), f.name)
        assert (a.f_stop, a.exposure_time) == (b.f_stop, b.exposure_time)
    assert tcam.FULL_FRAME_WIDTH == jcam.FULL_FRAME_WIDTH


def test_write_pfm_reads_back(tmp_path):
    img = np.random.default_rng(0).uniform(0, 4, (5, 7, 3)).astype(np.float32)
    tpfm.write_pfm(str(tmp_path / 'a.pfm'), img)
    jpfm.write_pfm(str(tmp_path / 'b.pfm'), img)
    assert (tmp_path / 'a.pfm').read_bytes() == (tmp_path / 'b.pfm').read_bytes()
    np.testing.assert_array_equal(jpfm.read_pfm(str(tmp_path / 'a.pfm')), img)
    with pytest.raises(ValueError):
        tpfm.write_pfm(str(tmp_path / 'c.pfm'), img[..., :2])
