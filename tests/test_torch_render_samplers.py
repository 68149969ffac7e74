"""Every progressive sampler through ``render.render``: lt, ptlt, bdpt1,
ppm, kmlt and vmlt (``PTConfig.sampler``), run by the CLI on the CPU on
0002_mb at 32x32, give the image of the loop that once stepped them in
the CLI (one ``render_sample`` a progression, summed from the first;
bdpt1 threading its strategy table from step to step), bit for bit, and
so does a run resumed from the ``.fb`` checkpoint at the next sample
index."""

import os

import pytest
import torch

from corona13_tpu_torch import __main__ as cli
from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch.io import fb as fb_io
from corona13_tpu_torch.samplers import bdpt1, kmlt, lt, ppm, ptlt, vmlt
from corona13_tpu_torch.samplers import pt as pt_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = os.path.join(ROOT, 'data', 'golden', 'scenes', '0002_mb', 'test.nra2')
STEPS = {'lt': lt.render_sample, 'ptlt': ptlt.render_sample,
         'ppm': ppm.render_sample, 'kmlt': kmlt.render_sample,
         'vmlt': vmlt.render_sample}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread per process, as the other port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def mb():
    return tscene.fit_film(tscene.load_scene(MB, device='cpu')[0], 32, 32)


def _stepped(scene, cfg, sampler, first, spp):
    """Progressions first .. first+spp-1 as the CLI's own loop summed
    them: one progression a call, from the first's output."""
    table = bdpt1.ConfigTable.create(cfg) if sampler == 'bdpt1' else None
    acc = None
    with torch.no_grad():
        for s in range(first, first + spp):
            if table is None:
                out = STEPS[sampler](scene, cfg, s)
            else:
                out, table = bdpt1.render_sample(scene, cfg, s, table)
            acc = out if acc is None else acc + out
    return acc.numpy()


@pytest.mark.parametrize('sampler', ['lt', 'ptlt', 'bdpt1', 'ppm', 'kmlt',
                                     'vmlt'])
def test_cli_renders_the_stepped_loops_image(mb, tmp_path, sampler):
    out = str(tmp_path / sampler)
    args = [MB, '-w', '32', '-h', '32', '--sampler', sampler, '--max-verts',
            '4', '--mf', '4', '--seed', '5', '--device', 'cpu', '-x', out]
    cfg = pt_mod.PTConfig(width=32, height=32, max_verts=4, mf=4, seed=5)
    assert cli.main(args + ['-s', '2']) == 0
    want = _stepped(mb, cfg, sampler, 0, 2)
    got = fb_io.Framebuffer.load(out + '.fb')
    assert got.spp == 2 and want.max() > 0
    assert torch.equal(torch.as_tensor(got.data), torch.as_tensor(want))
    assert cli.main(args + ['-s', '1', '--retain-framebuffer']) == 0
    want = want + _stepped(mb, cfg, sampler, 2, 1)
    got = fb_io.Framebuffer.load(out + '.fb')
    assert got.spp == 3
    assert torch.equal(torch.as_tensor(got.data), torch.as_tensor(want))
