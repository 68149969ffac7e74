"""The heterogeneous grid's march kernel (``ops/hete_cuda.py``,
``csrc/hete_march.cu``) and its dispatch in ``models/medium.py``.

On the CPU (tier 1): CPU tensors take the plain march; on the card a
density that requires grad raises (the kernel has no gradient in it);
the graph the card's march is given where autograd needs one
(``grid_sample_graph``, ``grid_transmit_graph``: the kernel's values, a
surrogate's gradient), fed the plain march's values and sums, gives the
plain march's gradients; the launch counters' keys, the ctypes binding
against the C struct and the kernel's IEEE build.

On a CUDA card (marked ``gpu``, skipped without one): the kernel against
the plain march on the same card, on the 0031_hete grid and on a
constant grid, both modes.  Each step's optical depth is the plain
path's bit for bit; only the running sum's order differs (the kernel's
is sequential in double, the card's scan and sum are float trees), so:

- scatter decisions equal on >= 99.99% of the grid lanes;
- the weight bit-equal, and the distance bit-equal where neither
  scatters (t_hit);
- a scatter distance within 1e-6 relative, plus the inversion's
  amplification of a 1e-6 relative error of the running sum:
  dx * 1e-6 * cum_before / dtau_k;
- T = exp(-tau) within 1e-6 * max(1, tau) relative: the sum's rounding
  is an absolute error of tau, which T carries as a relative one (tau
  reaches 43 in 0031_hete's grid, where a float tree's few ulps are
  several 1e-6);
- lanes of the homogeneous skin medium, vacuum lanes and dead lanes
  (t_hit 0) of a medium other than the grid bit-identical to the
  homogeneous results, and two launches bit-identical;
- with a graph, the gradients in the rays, t, sigma_t, sigma_s and the
  homogeneous results those of the plain march (where the scatter
  decisions agree), and a 0031_hete frame's gradient in sigma_t too.
"""

import contextlib
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from corona13_tpu_torch import scene as tscene
from corona13_tpu_torch import tracing
from corona13_tpu_torch.io import vol as tvol
from corona13_tpu_torch.models import medium as tmed
from corona13_tpu_torch.models import medium_hete as thete
from corona13_tpu_torch.ops import cuda_lib, hete_cuda

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'corona13_tpu_torch')
SCENE = os.path.join(os.path.dirname(PACKAGE), 'data', 'golden', 'scenes',
                     '0031_hete', 'test.nra2')
MF = 4
SKIN = 11      # the 0031_hete skin's homogeneous interior
VACUUM = -1


def _scene(dev, grid='0031_hete'):
    sc, _ = tscene.load_scene(SCENE, device=dev)
    if grid == 'const':
        d = np.full((64, 64, 64), 0.4, np.float32)
        vf = tvol.VolFile(d, np.zeros_like(d), [-1.0, -1.5, 1.0, 2.0, 1.5, 4.0],
                          1.0, np.zeros(3), np.zeros(3))
        vol = thete.from_volfile(vf, 2.0, 3.0, 0.0, 0.0,
                                 mat_id=sc.vol.mat_id, device=dev)
        sc = dataclasses.replace(sc, vol=vol)
    return sc


def _case(vol, n, seed, dev):
    """Lanes of every kind the march meets: rays entering the box from
    outside and starting inside it, along voxel faces and along the box's
    faces, zero-length segments (a ray leaving the box from its face, and
    t_hit 0: a dead lane), t_hit 3.4e38 on every 11th lane, rnd 0 and
    1 - 2^-24; the grid's medium on 60% of the lanes, the skin's on 20%,
    vacuum on the rest."""
    r = np.random.default_rng(seed)
    lo, hi = vol.lo.cpu().numpy(), vol.hi.cpu().numpy()
    ext = hi - lo
    size = float(np.abs(ext).max())
    inner = (lo + ext * r.uniform(-0.2, 1.2, (n, 3))).astype(np.float32)
    w = r.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    org = (inner - 3.0 * w * size).astype(np.float32)
    kind = np.arange(n) % 10
    org[kind < 3] = inner[kind < 3]                       # inside the box
    res = np.array(vol.density.shape[::-1])
    for k, faces in ((7, 'voxel'), (8, 'box')):
        sel = np.flatnonzero(kind == k)
        axis = r.integers(0, 3, sel.size)
        w[sel] = 0.0
        w[sel, axis] = r.choice([-1.0, 1.0], sel.size)
        for c in range(3):
            if faces == 'voxel':
                cut = r.integers(0, res[c] + 1, sel.size)
                on = (lo[c] + ext[c] / res[c] * cut).astype(np.float32)
            else:
                on = np.where(r.integers(0, 2, sel.size) == 0, lo[c], hi[c])
            org[sel, c] = np.where(axis == c, np.where(
                w[sel, c] > 0, lo[c] - 0.5, hi[c] + 0.5), on)
    sel = np.flatnonzero(kind == 9)                        # leaving the box
    axis = r.integers(0, 3, sel.size)
    org[sel] = inner[sel]
    w[sel] = 0.0
    w[sel, axis] = 1.0
    org[sel, axis] = hi[axis]
    t_hit = (r.uniform(0, 8, n) * size).astype(np.float32)
    t_hit[::11] = 3.4e38
    t_hit[5::23] = 0.0                                     # dead lanes
    rnd = r.uniform(0, 1, n).astype(np.float32)
    rnd[::13] = 0.0
    rnd[6::17] = np.float32(1.0 - 2.0 ** -24)
    med = np.where(r.uniform(size=n) < 0.6, vol.mat_id,
                   np.where(r.uniform(size=n) < 0.5, SKIN, VACUUM))
    lam = (360.0 + 470.0 * r.uniform(size=(n, MF))).astype(np.float32)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(med, torch.int64), t(lam), t(org), t(w), t(t_hit), t(rnd))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: the dispatch's device
    test, without one."""

    @property
    def is_cuda(self):
        return True


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


# --- the dispatch, on the CPU ------------------------------------------------

@pytest.fixture(scope='module')
def cpu_scene():
    return _scene('cpu')


@pytest.mark.parametrize('mode', ['sample', 'transmit'])
def test_cpu_takes_the_plain_march(cpu_scene, mode):
    sc = cpu_scene
    med, lam, org, w, t_hit, rnd = _case(sc.vol, 2048, 1, 'cpu')
    before = dict(tracing.launches)
    if mode == 'sample':
        got = tmed.sample_dist_scene(sc, med, lam, org, w, t_hit, rnd)
        want = tmed.grid_sample_plain(
            sc.vol, med, org, w, t_hit, rnd,
            *tmed.sample_dist(sc.materials, med, lam, t_hit, rnd))
    else:
        got = (tmed.transmittance_scene(sc, med, lam, org, w, t_hit),)
        want = (tmed.grid_transmit_plain(
            sc.vol, med, org, w, t_hit,
            tmed.transmittance(sc.materials, med, lam, t_hit)),)
    assert _same(got, want)
    assert tracing.launches == before      # nothing counted on the CPU


@pytest.mark.parametrize('mode', ['sample', 'transmit'])
def test_density_gradient_raises_on_the_card(cpu_scene, mode):
    """The kernel has no gradient in the density: on the card a grid whose
    density requires grad raises before any launch (no plain march runs
    there in its place)."""
    sc = cpu_scene
    med, lam, org, w, t_hit, rnd = _case(sc.vol, 256, 2, 'cpu')
    vol = dataclasses.replace(sc.vol,
                              density=sc.vol.density.clone().requires_grad_())
    sc = dataclasses.replace(sc, vol=vol)
    card_org = org.as_subclass(_OnCard)
    assert card_org.is_cuda
    before = dict(tracing.launches)
    with pytest.raises(NotImplementedError, match='density'):
        if mode == 'sample':
            tmed.sample_dist_scene(sc, med, lam, card_org, w, t_hit, rnd)
        else:
            tmed.transmittance_scene(sc, med, lam, card_org, w, t_hit)
    assert tracing.launches == before


def _plain_march(vol, med, org, w, t_hit, rnd=None):
    """What the kernel hands the graph, from the plain march: 'sample' (rnd
    given) the scatter and distance and aux (k, the densities' sum before
    the first crossing, the density at it; 0, 0, 0 where none crosses);
    'transmit' T and aux (the densities' sum, 0, 0)."""
    with torch.no_grad():
        a, b = thete._segment(vol, org, w, t_hit)
        x, dx = thete._march_x(org, w, a, b)
        rho = thete.density_at(vol, x)
        aux = torch.zeros(*med.shape, 3)
        if rnd is None:
            aux[..., 0] = rho.sum(-1)
            return thete.transmittance(vol, org, w, t_hit), aux
        cum = torch.cumsum(rho * vol.sigma_t * dx[..., None], dim=-1)
        target = -torch.log(torch.clamp(1.0 - rnd, min=1e-20))
        crossed = cum >= target[..., None]
        any_cross = crossed.any(-1)
        k = torch.argmax(crossed.to(torch.int32), dim=-1)
        steps = torch.arange(thete.N_MARCH)
        aux[..., 0] = torch.where(any_cross, k.float(), 0.0)
        aux[..., 1] = torch.where(any_cross, (rho * (steps < k[..., None])
                                              ).sum(-1), 0.0)
        aux[..., 2] = torch.where(any_cross, rho.gather(-1, k[..., None])[
            ..., 0], 0.0)
        scat, dist, _ = thete.sample_dist(vol, org, w, t_hit, rnd)
        return (scat, dist), aux


def _grad_case(sc, n, seed, dev):
    """A case whose rays, t, sigma_t, sigma_s and homogeneous results
    require grad; the leaves and the scene that holds them."""
    med, lam, org, w, t_hit, rnd = _case(sc.vol, n, seed, dev)
    keep = t_hit < 1e30          # the 3.4e38 lanes have no gradient in t
    leaves = dict(org=org.clone().requires_grad_(),
                  w=w.clone().requires_grad_(),
                  t_hit=torch.where(keep, t_hit, 1e4).requires_grad_(),
                  sigma_t=sc.vol.sigma_t.clone().requires_grad_(),
                  sigma_s=sc.vol.sigma_s.clone().requires_grad_())
    vol = dataclasses.replace(sc.vol, sigma_t=leaves['sigma_t'],
                              sigma_s=leaves['sigma_s'])
    return dataclasses.replace(sc, vol=vol), leaves, med, lam, rnd


def _grads(outs, leaves, seed):
    """d/d leaves of sum(out * r) over the float outputs, r random."""
    g = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.rand(o.shape, generator=g).to(o.device)).sum()
               for o in outs if o.dtype == torch.float32)
    return dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), retain_graph=True, allow_unused=True)))


def _close_grads(got, want, rtol):
    for k in want:
        if want[k] is None:          # sigma_s, in T
            assert got[k] is None, k
            continue
        assert got[k] is not None, k
        g, p = got[k].cpu(), want[k].cpu()
        assert torch.isfinite(g).all(), k
        tol = rtol * float(p.abs().max()) + 1e-30
        assert float((g - p).abs().max()) <= tol, (k, float(
            (g - p).abs().max()), tol)
        assert float(p.abs().max()) > 0, k


@pytest.mark.parametrize('mode', ['sample', 'transmit'])
def test_graph_gives_the_plain_gradient(cpu_scene, mode):
    """grid_sample_graph / grid_transmit_graph fed the plain march's values
    and sums (what the kernel writes) give the plain march's values bit
    for bit and its gradients in the rays, t, sigma_t, sigma_s and the
    homogeneous results."""
    sc, leaves, med, lam, rnd = _grad_case(cpu_scene, 4096, 5, 'cpu')
    vol, org, w, t_hit = sc.vol, leaves['org'], leaves['w'], leaves['t_hit']
    if mode == 'sample':
        homog = tmed.sample_dist(sc.materials, med, lam, t_hit, rnd)
        march, aux = _plain_march(vol, med, org, w, t_hit, rnd)
        got = tmed.grid_sample_graph(vol, med, org, w, t_hit, rnd, homog,
                                     march, aux)
        want = tmed.grid_sample_plain(vol, med, org, w, t_hit, rnd, *homog)
    else:
        homog = tmed.transmittance(sc.materials, med, lam, t_hit)
        t2, aux = _plain_march(vol, med, org, w, t_hit)
        march = torch.where((med == vol.mat_id)[..., None], t2[..., None],
                            homog.detach())
        got = (tmed.grid_transmit_graph(vol, med, org, w, t_hit, homog,
                                        march, aux),)
        want = (tmed.grid_transmit_plain(vol, med, org, w, t_hit, homog),)
    assert _same([x.detach() for x in got], [x.detach() for x in want])
    _close_grads(_grads(got, leaves, 9), _grads(want, leaves, 9), 1e-4)


def test_counter_keys_exist():
    for k in ('hete_sample', 'hete_transmit'):
        assert k in tracing.launches
    assert 'hete_cuda.build' in tracing.SETUP_SPANS


def test_march_rejects_bad_inputs(cpu_scene):
    """The wrapper's checks come before the build: each raises here."""
    vol = cpu_scene.vol
    med, lam, org, w, t_hit, rnd = _case(vol, 64, 4, 'cpu')
    out = torch.ones(64, MF)
    scat, dist = torch.zeros(64, dtype=torch.bool), t_hit.clone()
    kw = dict(rnd=rnd, scat=scat, dist=dist)
    bad = [(('emit', vol, med, org, w, t_hit, out), kw, ValueError),
           (('sample', vol, med, org, w, t_hit, out), {}, TypeError),
           (('sample', vol, med, org[:, :2].contiguous(), w, t_hit, out), kw,
            ValueError),
           (('transmit', vol, med.float(), org, w, t_hit, out), {}, TypeError),
           (('transmit', vol, med, org, w, t_hit, out.t()), {}, ValueError),
           (('transmit', vol, med, org, w, t_hit[:32], out), {}, ValueError),
           (('sample', vol, med, org, w, t_hit, out),
            dict(kw, aux=torch.zeros(64, 2)), ValueError)]
    for args, kwargs, err in bad:
        with pytest.raises(err):
            hete_cuda.march(*args, **kwargs)


def test_binding_matches_the_c_struct():
    with open(os.path.join(PACKAGE, 'csrc', 'hete_march.cu')) as f:
        src = f.read()
    body = re.search(r'struct Corona13HeteArgs \{(.*?)\};', src, re.S).group(1)
    fields = [name for decl in re.sub(r'//[^\n]*', '', body).split(';')
              for name in re.findall(r'(\w+)\s*(?:,|$)', decl.strip())]
    assert fields == [name for name, _ in hete_cuda._Args._fields_]
    for approx in ('__expf', '__logf', '__fdividef', '__frcp', '__fadd',
                   '__fmul', 'fmaf('):
        assert approx not in src, approx
    assert '-fmad=false' in cuda_lib.NVCC_FLAGS


# --- the kernel against the plain march, on the card -------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    hete_cuda.build()
    return torch.device('cuda')


def _plain_terms(vol, org, w, t_max):
    """The plain march's cum before each lane's first crossing terms."""
    a, b = thete._segment(vol, org, w, t_max)
    dtau, dx = thete._march_tau(vol, org, w, a, b)
    return dtau, torch.cumsum(dtau, dim=-1), dx


@pytest.mark.gpu
@pytest.mark.parametrize('grid', ['0031_hete', 'const'])
@pytest.mark.parametrize('mode', ['sample', 'transmit'])
def test_kernel_matches_plain(cuda, grid, mode):
    sc = _scene(cuda, grid)
    vol = sc.vol
    n = 1 << 17
    med, lam, org, w, t_hit, rnd = _case(vol, n, 7, cuda)
    key = f'hete_{mode}'
    before = dict(tracing.launches)
    with torch.no_grad():
        if mode == 'sample':
            homog = tmed.sample_dist(sc.materials, med, lam, t_hit, rnd)
            k1 = tmed.sample_dist_scene(sc, med, lam, org, w, t_hit, rnd)
            k2 = tmed.sample_dist_scene(sc, med, lam, org, w, t_hit, rnd)
            plain = tmed.grid_sample_plain(vol, med, org, w, t_hit, rnd,
                                           *homog)
        else:
            homog = (tmed.transmittance(sc.materials, med, lam, t_hit),)
            k1 = (tmed.transmittance_scene(sc, med, lam, org, w, t_hit),)
            k2 = (tmed.transmittance_scene(sc, med, lam, org, w, t_hit),)
            plain = (tmed.grid_transmit_plain(vol, med, org, w, t_hit,
                                              homog[0]),)
        dtau, cum, dx = _plain_terms(vol, org, w, t_hit)
    torch.cuda.synchronize()
    assert tracing.launches[key] == before[key] + 2
    assert _same(k1, k2)                       # two launches, same bits
    grid_l = med == vol.mat_id
    other = ~grid_l
    assert _same([x[other] for x in k1], [x[other] for x in homog])
    assert bool(((t_hit == 0) & other).any())
    g = grid_l.cpu().numpy()
    k = [x.cpu().numpy()[g] for x in k1]
    p = [x.cpu().numpy()[g] for x in plain]
    dtau, cum, dx = (x.cpu().numpy()[g] for x in (dtau, cum, dx))
    if mode == 'transmit':
        tau = cum[:, -1]
        tol = 1e-6 * np.maximum(1.0, tau)[:, None] * p[0] + 1e-30
        np.testing.assert_array_less(np.abs(k[0] - p[0]), tol)
        assert (p[0] < 0.99).mean() > 0.05
        return
    agree = k[0] == p[0]
    assert agree.mean() >= 0.9999, agree.mean()
    assert 0.02 < p[0].mean() < 0.98
    np.testing.assert_array_equal(k[2][agree].view(np.int32),
                                  p[2][agree].view(np.int32))
    stay = agree & ~p[0]
    np.testing.assert_array_equal(k[1][stay].view(np.int32),
                                  p[1][stay].view(np.int32))
    both = agree & p[0]
    target = -np.log(np.maximum(1.0 - rnd.cpu().numpy()[g], 1e-20))
    first = np.argmax(cum >= target[:, None], axis=-1)
    rows = np.arange(first.size)
    before_k = np.where(first > 0, cum[rows, np.maximum(first - 1, 0)], 0.0)
    amp = dx * 1e-6 * before_k / np.maximum(dtau[rows, first], 1e-20)
    err = np.abs(k[1] - p[1])[both]
    tol = (1e-6 * np.abs(p[1]) + amp)[both]
    assert (err <= tol).all(), (err / np.maximum(tol, 1e-30)).max()


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['sample', 'transmit'])
def test_kernel_gradient_matches_plain(cuda, mode):
    """With a graph the kernel runs too (one launch, into copies) and the
    gradients in the rays, t, sigma_t, sigma_s and the homogeneous results
    are the plain march's: lane by lane where the scatter decisions agree
    (1e-4 of the largest), summed for sigma_t and sigma_s (1e-3)."""
    sc, leaves, med, lam, rnd = _grad_case(_scene(cuda), 1 << 16, 11, cuda)
    vol, org, w, t_hit = sc.vol, leaves['org'], leaves['w'], leaves['t_hit']
    key = f'hete_{mode}'
    before = tracing.launches[key]
    if mode == 'sample':
        homog = tmed.sample_dist(sc.materials, med, lam, t_hit, rnd)
        got = tmed.sample_dist_scene(sc, med, lam, org, w, t_hit, rnd)
        want = tmed.grid_sample_plain(vol, med, org, w, t_hit, rnd, *homog)
        agree = got[0] == want[0]
        assert float(agree.float().mean()) >= 0.9999
    else:
        homog = tmed.transmittance(sc.materials, med, lam, t_hit)
        got = (tmed.transmittance_scene(sc, med, lam, org, w, t_hit),)
        want = (tmed.grid_transmit_plain(vol, med, org, w, t_hit, homog),)
        agree = torch.ones_like(med, dtype=torch.bool)
    assert tracing.launches[key] == before + 1
    assert all(x.requires_grad for x in got if x.dtype == torch.float32)
    g, p = _grads(got, leaves, 12), _grads(want, leaves, 12)
    lanes = {k: (g[k][agree], p[k][agree]) for k in ('org', 'w', 't_hit')}
    _close_grads({k: v[0] for k, v in lanes.items()},
                 {k: v[1] for k, v in lanes.items()}, 1e-4)
    _close_grads({k: g[k] for k in ('sigma_t', 'sigma_s')
                  if mode == 'sample' or k == 'sigma_t'},
                 {k: p[k] for k in ('sigma_t', 'sigma_s')
                  if mode == 'sample' or k == 'sigma_t'}, 1e-3)


@contextlib.contextmanager
def _plain_media():
    """medium.sample_dist_scene / transmittance_scene by the plain march,
    on the card too: the reference of a frame."""
    real = tmed.sample_dist_scene, tmed.transmittance_scene

    def sample(scene, med, lam, org, w, t_hit, rnd):
        return tmed.grid_sample_plain(
            scene.vol, med, org, w, t_hit, rnd,
            *tmed.sample_dist(scene.materials, med, lam, t_hit, rnd))

    def transmit(scene, med, lam, org, w, dist):
        return tmed.grid_transmit_plain(
            scene.vol, med, org, w, dist,
            tmed.transmittance(scene.materials, med, lam, dist))
    tmed.sample_dist_scene, tmed.transmittance_scene = sample, transmit
    try:
        yield
    finally:
        tmed.sample_dist_scene, tmed.transmittance_scene = real


@pytest.mark.gpu
def test_frame_takes_the_kernel(cuda):
    """A 0031_hete progression at 128x72 (max_verts 8, media, NEE): one
    sample and one transmit launch a bounce; its image against the same
    progression with the plain march, by the benchmark's measure: at most
    0.1% of the pixels off by more than 1e-6 + 1e-4 |plain|; and the
    frame's gradient in the grid's sigma_t, through the kernel's graph,
    against the plain march's (1e-3)."""
    from corona13_tpu_torch.samplers import pt as pt_mod
    sc = tscene.fit_film(_scene(cuda), 128, 72)
    cfg = pt_mod.PTConfig(width=128, height=72, max_verts=8, mf=4,
                          use_nee=True, media=True)
    before = dict(tracing.launches)
    with torch.no_grad():
        img = pt_mod.render_sample(sc, cfg, 3)
    moved = {k: tracing.launches[k] - before[k]
             for k in ('hete_sample', 'hete_transmit')}
    assert moved == {'hete_sample': 7, 'hete_transmit': 7}
    with torch.no_grad(), _plain_media():
        plain = pt_mod.render_sample(sc, cfg, 3)
    assert tracing.launches['hete_sample'] == before['hete_sample'] + 7
    off = ~(torch.abs(img - plain) <= 1e-6 + 1e-4 * torch.abs(plain))
    share = float(off.any(dim=-1).float().mean())
    assert share <= 1e-3, share
    assert float(img.sum()) > 0
    grads = []
    for ctx in (contextlib.nullcontext(), _plain_media()):
        st = sc.vol.sigma_t.clone().requires_grad_()
        s2 = dataclasses.replace(sc, vol=dataclasses.replace(sc.vol,
                                                             sigma_t=st))
        with ctx:
            loss = pt_mod.render_sample(s2, cfg, 3).sum()
        grads.append(float(torch.autograd.grad(loss, st)[0]))
    assert tracing.launches['hete_transmit'] == before['hete_transmit'] + 14
    assert grads[1] != 0.0 and np.isfinite(grads[0])
    assert abs(grads[0] - grads[1]) <= 1e-3 * abs(grads[1]), grads
