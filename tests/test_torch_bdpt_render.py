"""bdpt on the port's normal path, on the CPU on the 0002_mb scene:
``render.render`` with ``cfg.sampler == 'bdpt'`` equals the sum of
``bdpt.render_sample`` bit for bit, the CLI's ``--sampler bdpt`` writes
the image of its progressions (resumed ones too), the ``bdpt.*`` and
``splat.general`` spans lie inside ``render.progression`` as named and
the connection counter equals a count taken at the shadow rays, the
benchmark's plain reference of bdpt equals the program and its bfloat16
control fails the cell's limit, and the reference's no-``time`` subpaths
on the moving cube, pinned."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from corona13_tpu import scene as jscene
from corona13_tpu.samplers import bdpt as jbdpt
from corona13_tpu.samplers import pt as jpt
from corona13_tpu_torch import __main__ as cli
from corona13_tpu_torch import convert
from corona13_tpu_torch import render as render_mod
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import tracing
from corona13_tpu_torch.io import fb as fb_io
from corona13_tpu_torch.io import pfm as pfm_io
from corona13_tpu_torch.samplers import bdpt
from corona13_tpu_torch.samplers import pt as pt_mod
from portbench import compare, scenes
from portbench.reference import bdpt as ref_bdpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = os.path.join(ROOT, 'data', 'golden', 'scenes', '0002_mb', 'test.nra2')
CONFIG = os.path.join(ROOT, 'portbench', 'configs', '0002_mb_bdpt.json')
W, H = 32, 24
CFG = pt_mod.PTConfig(width=W, height=H, max_verts=6, mf=4, seed=2024,
                      sampler='bdpt')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process, as the other port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(w=W, h=H):
    return tscene.fit_film(tscene.load_scene(MB, device='cpu')[0], w, h)


@pytest.fixture(scope='module')
def mb():
    return _scene()


def _sum(scene, cfg, samples):
    fb = None
    with torch.no_grad():
        for s in samples:
            out = bdpt.render_sample(scene, cfg, s)
            fb = out if fb is None else fb + out
    return fb.numpy()


@pytest.mark.parametrize('first,batch', [(0, 0), (2, 3)])
def test_render_equals_sum_of_render_sample(mb, first, batch):
    """Whatever ``batch`` asks, one progression a step: bdpt's batch copies
    would trace the same paths."""
    res = render_mod.render(mb, CFG, spp=3, batch=batch, first=first)
    want = _sum(mb, CFG, range(first, first + 3))
    assert res.spp == 3 and res.path_hist is None
    assert np.array_equal(res.fb, want) and want.max() > 0
    with pytest.raises(ValueError):
        render_mod.render(mb, CFG.replace(sampler='mlt'), spp=1)


def test_cli_bdpt_writes_the_image_of_its_progressions(tmp_path, capsys):
    """The CLI's image is that of progressions 0, 1 and, resumed, 2, as the
    stepped loop wrote it: their sums accumulated into the framebuffer."""
    out = str(tmp_path / 'b')
    args = [MB, '-w', '32', '-h', '32', '--sampler', 'bdpt', '--max-verts',
            '6', '--mf', '4', '--seed', '5', '--device', 'cpu', '-x', out]
    assert cli.main(args + ['-s', '2']) == 0
    assert cli.main(args + ['-s', '1', '--retain-framebuffer']) == 0
    sc = _scene(32, 32)
    cfg = CFG.replace(width=32, height=32, seed=5)
    fbf = fb_io.Framebuffer.open(str(tmp_path / 'want.fb'), 32, 32)
    fbf.accumulate(_sum(sc, cfg, (0, 1)), 2)
    fbf.accumulate(_sum(sc, cfg, (2,)), 1)
    fbf.flush(iso=float(sc.camera.iso))
    got = pfm_io.read_pfm(out + '_fb00.pfm')
    assert np.array_equal(got, fbf.image) and got.max() > 0
    assert 'resuming at 2 spp' in capsys.readouterr().out


def test_spans_and_connect_counter(mb, monkeypatch):
    """Under a CPU profile and the counters: the spans in their order
    inside ``render.progression``, no ``bdpt.*`` span inside another,
    each ``splat.general`` inside a ``bdpt.camera``; the image equals the
    untraced one; ``connect_live_share`` equals the lanes that the shadow
    rays found unblocked over the lanes of every shadow-ray pass."""
    want = _sum(mb, CFG, (0,))
    shots = []
    real = bdpt.occluded

    def occluded(geom, org, direction, t_max, **kw):
        blocked = real(geom, org, direction, t_max, **kw)
        shots.append((t_max > 0) & ~blocked)
        return blocked
    monkeypatch.setattr(bdpt, 'occluded', occluded)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.counting() as counters:
            fb = render_mod.render(mb, CFG, spp=1).fb
    assert np.array_equal(fb, want)
    events = list(prof.events())
    (root,) = [e for e in events if e.name == 'render.progression']
    kids = [e.name for e in root.cpu_children if e.name in tracing.SPAN_NAMES]
    nt, nl = CFG.max_verts - 1, CFG.max_verts - 2
    assert kids == (['bdpt.subpath'] * (1 + nt) + ['bdpt.subpath'] * nl
                    + ['bdpt.connect'] * 15 + ['bdpt.camera'] * 4
                    + ['bdpt.splat', 'render.readback'])
    for e in events:
        if e.name.startswith('bdpt.'):
            p = e.cpu_parent
            while p is not None:
                assert not p.name.startswith('bdpt.'), (e.name, p.name)
                p = p.cpu_parent
    general = [e for e in events if e.name == 'splat.general']
    assert len(general) == 4
    assert all(e.cpu_parent.name == 'bdpt.camera' for e in general)
    rows = counters.connections()
    assert [r[:2] for r in rows] == (
        [(s, t) for s in range(1, nl + 1) for t in range(2, nt + 2)
         if s + t <= CFG.max_verts] + [(s, 1) for s in range(1, nl + 1)])
    assert len(shots) == len(rows) == 14
    assert all(c >= v for _, _, c, v, _ in rows)
    n = W * H
    direct = sum(int(x.sum()) for x in shots) / (n * len(shots))
    assert counters.connect_live_share() == direct
    assert 0.0 < direct < 1.0
    assert sum(counters.widths()) == n * (nt + nl - 1)


def test_reference_equals_program_and_control_fails():
    """The benchmark's plain reference of bdpt against the program at 64x48
    (no pixel off), and its bfloat16 control against it (off by more than
    the cell's limit)."""
    with open(CONFIG) as f:
        config = json.load(f)
    keys = dict(config['render'], width=64, height=48)
    limit = config['limits']['pixels_off']
    prog = _scene(64, 48)
    ref = scenes.build(config['scene'], ref_bdpt.SIDE, ROOT, 'cpu', 64, 48)
    for seed in (3630796758, 12345):
        img = render_mod.render(prog, pt_mod.PTConfig(seed=seed, **keys),
                                spp=1, batch=1).fb
        want = ref_bdpt.progression(ref, keys, seed)
        assert want.mean() > 0
        assert compare.pixels_off(img, want) == 0.0
        lowp = ref_bdpt.progression(ref, keys, seed, lowp=True)
        assert compare.pixels_off(lowp, want) > limit


def _images_agree(got, want, share=0.99):
    """Each pixel within 1e-4 of the largest pixel, on >= share of the
    pixels (a branch flip on a float32 near-tie moves a few)."""
    top = float(np.abs(want).max())
    assert top > 0
    close = np.isclose(got, want, rtol=0, atol=1e-4 * top).all(axis=-1)
    assert close.mean() >= share, close.mean()


def test_bdpt_ignores_shutter_time_reference_defect():
    """Reference defect, reproduced: bdpt.py traces its subpaths and
    connections without ``time``, so the 0002_mb cube renders where it
    stands at shutter open: bdpt of the moving scene equals bdpt of the
    same scene held still (no shutter-close triangles), in the JAX package
    and in the port, the two agree, while pt (which passes the time)
    differs."""
    js = jscene.fit_film(jscene.load_scene(MB)[0], W, H)
    assert js.geom.has_motion
    still = js.replace(geom=js.geom.replace(
        has_motion=False,
        tri_bvh=js.geom.tri_bvh.replace(leaf_data_t1=None)))
    ts_mb = convert.scene_from_numpy(js, device='cpu')
    ts_still = convert.scene_from_numpy(still, device='cpu')
    cfg_j = jpt.PTConfig(width=W, height=H, max_verts=4, mf=2)
    cfg_t = pt_mod.PTConfig(width=W, height=H, max_verts=4, mf=2)
    got = bdpt.render_sample(ts_mb, cfg_t, 1)
    assert torch.equal(got, bdpt.render_sample(ts_still, cfg_t, 1))
    j_mb = np.asarray(jbdpt.render_sample(js, cfg_j, jnp.uint32(1)))
    j_still = np.asarray(jbdpt.render_sample(still, cfg_j, jnp.uint32(1)))
    np.testing.assert_array_equal(j_mb, j_still)
    _images_agree(got.numpy(), j_mb)
    p_mb = pt_mod.render_sample(ts_mb, cfg_t, 1)
    p_still = pt_mod.render_sample(ts_still, cfg_t, 1)
    assert not torch.equal(p_mb, p_still)
