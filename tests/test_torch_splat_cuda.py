"""The general splat's binned sum (``ops/splat_cuda.py``,
``csrc/splat_general.cu``) and its dispatch in ``ops/splat.py``, on the
CPU (tier 1); the card's tests are in ``tests/test_torch_gpu.py``.

- CPU tensors take the sort path (``_scatter_sorted``) with its bits;
- the chain's algorithm, written out in numpy (taps off the film, left
  out or +-0.0 in all three colours dropped; each pixel's taps sorted by
  colour 0's bits unsigned, 1's signed, 2's unsigned and summed serially
  from +0.0), gives the sort path's bits, and so does the sort path
  handed only the taps the chain keeps, a pixel whose taps are all zero
  included;
- the autograd Functions' backward formulas (``_scatter_grad``,
  ``_footprint_grad``) against autograd through the sort path;
- the tap counter against a count by hand; the taps of splats with a
  coordinate that is not finite left out by the sort path, the counter and
  the gradient alike;
- the ctypes binding against the C struct, the wrapper's checks, the
  library's IEEE build, its CUDA runtime calls (none synchronises) and
  its set-up span.
"""

import os
import re

import numpy as np
import pytest
import torch

from corona13_tpu_torch import tracing
from corona13_tpu_torch.ops import cuda_lib, splat, splat_cuda

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'corona13_tpu_torch')
H, W = 9, 14
KINDS = ['box', 'bilin', 'blackmanharris', 'spline', 'gaussian', 'dbor']


def _inputs(n, seed):
    """Splats over the film and its border (a hot pixel of 64), half of
    them +0.0 or -0.0 in every colour, one in a single colour, and inf."""
    g = np.random.default_rng(seed)
    pi = g.uniform(-2.0, W + 2.0, n).astype(np.float32)
    pj = g.uniform(-2.0, H + 2.0, n).astype(np.float32)
    pi[:64], pj[:64] = pi[0], pj[0]
    col = (10.0 ** g.uniform(-2, 3, (n, 3))).astype(np.float32)
    dead = g.uniform(size=n) < 0.5
    col[dead] = np.where(g.uniform(size=(n, 1)) < 0.5, 0.0, -0.0)[dead]
    col[70, 1] = -0.0
    col[71, 2] = np.inf
    return torch.as_tensor(pi), torch.as_tensor(pj), torch.as_tensor(col)


def _scatters(kind, pi, pj, col):
    """The framebuffer's shape and the plain path's scatters for kind."""
    if kind == 'dbor':
        return (splat.N_DBOR, H, W, 3), splat._dbor_taps(H, W, pi, pj, col)
    return (H, W, 3), splat._taps(H, W, pi, pj, col, kind)


def _fb(shape, seed=5):
    fb = torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))
    fb[..., 0, 0, :] = -0.0
    return fb


def _flat(fb, yi, xi, contrib, keep):
    """A scatter's taps as flat pixels, keep and [M, 3] colours."""
    flat = (yi * fb.shape[-2] + xi).reshape(-1)
    keep = (torch.ones_like(flat, dtype=torch.bool) if keep is None
            else keep.reshape(-1))
    return flat, keep, contrib.reshape(-1, 3)


def _binned(fb, flat, keep, vals):
    """The kernel chain's algorithm in numpy."""
    fb, flat, keep, vals = (x.numpy() for x in (fb, flat, keep, vals))
    n_pix = fb.size // 3
    bits = vals.view(np.uint32)
    ok = (flat >= 0) & (flat < n_pix) & keep & (vals != 0).any(-1)
    idx = np.nonzero(ok)[0]
    order = idx[np.lexsort((bits[idx, 2], bits[idx, 1].view(np.int32),
                            bits[idx, 0], flat[idx]))]
    sums = np.zeros((n_pix, 3), np.float32)
    for m in order:
        sums[flat[m]] = sums[flat[m]] + vals[m]
    return torch.as_tensor(fb.reshape(-1, 3) + sums).reshape(fb.shape)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize('kind', KINDS)
def test_cpu_takes_the_sort_path(kind, monkeypatch):
    """On CPU tensors splat and splat_dbor never reach the chain: their
    bits are the sort path's over the plain taps, called explicitly."""
    def refuse(*a, **k):
        raise AssertionError('the kernel chain was reached on the CPU')
    for name in ('build', 'footprint', 'scatter'):
        monkeypatch.setattr(splat_cuda, name, refuse)
    pi, pj, col = _inputs(400, 1)
    shape, scatters = _scatters(kind, pi, pj, col)
    want = _fb(shape)
    for t in scatters:
        want = splat._scatter_sorted(want, *t)
    if kind == 'dbor':
        got = splat.splat_dbor(_fb(shape), pi, pj, col)
    else:
        got = splat.splat(_fb(shape), pi, pj, col, kind)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('kind', KINDS)
def test_binned_sum_has_the_sort_paths_bits(kind):
    """The chain's algorithm (numpy) and the sort path handed only the
    taps the chain keeps give the sort path's bits, scatter by scatter."""
    pi, pj, col = _inputs(300, 2)
    shape, scatters = _scatters(kind, pi, pj, col)
    fb = _fb(shape)
    for t in scatters:
        flat, keep, vals = _flat(fb, *t)
        want = splat._scatter_sorted(fb, *t)
        assert torch.equal(_bits(_binned(fb, flat, keep, vals)), _bits(want))
        live = keep & (vals != 0).any(-1)
        assert 0 < int(live.sum()) < live.numel()
        fewer = splat._scatter_sorted(
            fb, flat[live] // fb.shape[-2], flat[live] % fb.shape[-2],
            vals[live])
        assert torch.equal(_bits(fewer), _bits(want))
        fb = want


def test_zero_taps_alone_leave_their_pixel():
    """A pixel whose only taps are +-0.0: fb + 0.0 (-0.0 becomes +0.0)
    whether the zeros are scattered or not."""
    fb = torch.zeros(2, 3, 3)
    fb[0, 1] = torch.tensor([-0.0, 0.5, -2.0])
    yi = torch.tensor([0, 0, 0, 1])
    xi = torch.tensor([1, 1, 1, 2])
    contrib = torch.tensor([[0.0, -0.0, 0.0], [-0.0, -0.0, -0.0],
                            [0.0, 0.0, -0.0], [1.0, -0.0, 3.0]])
    want = splat._scatter_sorted(fb, yi, xi, contrib)
    got = splat._scatter_sorted(fb, yi[3:], xi[3:], contrib[3:])
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(want[0, 1]),
                       _bits(torch.tensor([0.0, 0.5, -2.0])))
    flat, keep, vals = _flat(fb, yi, xi, contrib, None)
    assert torch.equal(_bits(_binned(fb, flat, keep, vals)), _bits(want))


@pytest.mark.parametrize('kind', KINDS)
def test_backward_formulas_match_autograd(kind):
    """The Functions' gradients against autograd through the sort path:
    the 4x4 filters' in col (``_footprint_grad``, 1e-6 of the largest
    value), and for the others each scatter's in its taps' colours
    (``_scatter_grad``, exactly)."""
    pi, pj, col = _inputs(200, 3)
    col = torch.where(torch.isfinite(col), col, 1.0)
    shape, scatters = _scatters(kind, pi, pj, col)
    g = _fb(shape, seed=6)
    if kind in ('blackmanharris', 'spline', 'gaussian'):
        c = col.clone().requires_grad_()
        _, (t,) = _scatters(kind, pi, pj, c)
        (splat._scatter_sorted(torch.zeros(shape), *t) * g).sum().backward()
        got = splat._footprint_grad(g, pi, pj, kind)
        assert float((got - c.grad).abs().max()) \
            <= 1e-6 * float(c.grad.abs().max())
        return
    for yi, xi, contrib, keep in scatters:
        leaf = contrib.detach().clone().requires_grad_()
        out = splat._scatter_sorted(torch.zeros(shape), yi, xi, leaf, keep)
        (out * g).sum().backward()
        flat = (yi * W + xi).reshape(-1)
        got = splat._scatter_grad(g, flat, None if keep is None
                                  else keep.reshape(-1))
        assert torch.equal(got.reshape(leaf.shape), leaf.grad)


def test_scatter_grad_leaves_out_taps_off_fb():
    g = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    flat = torch.tensor([0, 3, -1, 4, 2])
    keep = torch.tensor([True, True, True, True, False])
    got = splat._scatter_grad(g, flat, keep)
    want = torch.tensor([[0.0, 1, 2], [9, 10, 11], [0, 0, 0], [0, 0, 0],
                         [0, 0, 0]])
    assert torch.equal(got, want)


def test_counter_against_a_count_by_hand():
    """Box and bilin splats on a 3 x 4 film: the taps summed are those on
    the film and not +-0.0 in all three colours."""
    pi = torch.tensor([0.5, 1.5, 3.5, 9.0, 1.0])
    pj = torch.tensor([0.5, 2.5, 1.0, 1.0, 1.0])
    col = torch.tensor([[1.0, 0.0, 0.0], [0.0, -0.0, 0.0], [0.0, 0.0, 2.0],
                        [1.0, 1.0, 1.0], [-0.0, 0.0, 0.0]])
    fb = torch.zeros(3, 4, 3)
    with tracing.counting() as counters:
        splat.splat(fb, pi, pj, col, 'box')
        splat.splat(fb, pi, pj, col, 'bilin')
    # box: every splat lands (clamped); splats 0, 2 and 3 are not zero.
    # bilin, one scatter a corner (dy, dx) in (0, 0), (0, 1), (1, 0),
    # (1, 1): splat 0 at its pixel's centre weighs 1 at corner (0, 0) and
    # 0 at the others; splat 2 (x - 0.5 = 3.0, y - 0.5 = 0.5) weighs 0.5 at
    # corners (0, 0) and (1, 0) in column 3, and 0 in column 4, off the
    # film; splat 3 is off the film
    assert counters.splat_taps() == [(3, 5), (2, 5), (0, 5), (1, 5), (0, 5)]
    assert counters.summed_tap_share() == pytest.approx(6 / 25)
    assert tracing.Counters().summed_tap_share() is None


@pytest.mark.parametrize('kind', ['blackmanharris', 'spline', 'gaussian'])
def test_taps_of_non_finite_splats_are_left_out(kind):
    """Splats with a NaN or infinite coordinate: ``_footprint`` keeps none
    of their taps, so the sort path sums them nowhere, the counter counts
    none of them and their colours get no gradient (the rule the card's
    footprint keeps a copy of)."""
    pi, pj, col = _inputs(120, 4)
    col = torch.where(torch.isfinite(col), col, 1.0)
    bad = torch.tensor([80, 81, 82, 83])
    pi[bad] = torch.tensor([float('nan'), 3.0, float('inf'), -float('inf')])
    pj[bad] = torch.tensor([2.0, float('nan'), 4.0, float('inf')])
    f, yi, xi, keep = splat._footprint(H, W, pi, pj, kind)
    assert not keep[bad].any() and keep.any()
    good = torch.ones(pi.shape[0], dtype=torch.bool)
    good[bad] = False
    with tracing.counting() as counters:
        got = splat.splat(_fb((H, W, 3)), pi, pj, col, kind)
    want = splat.splat(_fb((H, W, 3)), pi[good], pj[good], col[good], kind)
    assert torch.equal(_bits(got), _bits(want))
    (summed, handed), = counters.splat_taps()
    assert handed == 16 * pi.shape[0]
    contrib = f[..., None] * col[:, None, None, :]
    assert summed == int((keep & (contrib != 0).any(-1)).sum())
    grad = splat._footprint_grad(_fb((H, W, 3), seed=6), pi, pj, kind)
    assert torch.equal(grad[bad], torch.zeros(4, 3))
    assert bool(torch.isfinite(grad).all())


def test_library_makes_no_synchronising_call():
    """The chain's host side calls only CUDA runtime functions that queue
    work on the given stream or read no device state: no copy back, no
    synchronisation, no allocation."""
    with open(os.path.join(PACKAGE, 'csrc', 'splat_general.cu')) as f:
        src = re.sub(r'//[^\n]*', '', f.read())
    calls = set(re.findall(r'\b(cuda[A-Z]\w*)\s*\(', src))
    assert calls == {'cudaMemsetAsync', 'cudaGetLastError',
                     'cudaFuncSetAttribute'}


def test_counter_off_and_setup_span():
    assert not tracing.counting_on()
    with tracing.counting():
        assert tracing.counting_on()
    assert 'splat_cuda.build' in tracing.SETUP_SPANS
    assert {k for k in tracing.launches if k.startswith('splat_')} == {
        'splat_scatter', 'splat_footprint'}


def test_binding_matches_the_c_struct():
    with open(os.path.join(PACKAGE, 'csrc', 'splat_general.cu')) as f:
        src = f.read()
    body = re.search(r'struct Corona13SplatArgs \{(.*?)\};', src, re.S).group(1)
    fields = [name for decl in re.sub(r'//[^\n]*', '', body).split(';')
              for name in re.findall(r'(\w+)\s*(?:,|$)', decl.strip())]
    assert fields == [name for name, _ in splat_cuda._Args._fields_]
    for approx in ('__expf', '__cosf', '__fdividef', '__frcp', '__fadd',
                   '__fmul', 'fmaf('):
        assert approx not in src, approx
    assert '-fmad=false' in cuda_lib.NVCC_FLAGS


def test_wrapper_rejects_bad_inputs():
    """The wrapper's checks come before the build: each raises here."""
    fb = torch.zeros(4, 5, 3)
    pi, pj, col = torch.zeros(8), torch.zeros(8), torch.zeros(8, 3)
    flat = torch.zeros(8, dtype=torch.int64)
    bad = [(splat_cuda.footprint, (fb.double(), pi, pj, col, 'gaussian'),
            TypeError),
           (splat_cuda.footprint, (fb[..., :2].contiguous(), pi, pj, col,
                                   'gaussian'), ValueError),
           (splat_cuda.footprint, (fb[None], pi, pj, col, 'gaussian'),
            ValueError),
           (splat_cuda.footprint, (fb, pi, pj[:4], col, 'gaussian'),
            ValueError),
           (splat_cuda.footprint, (fb, pi, pj, col.t().contiguous().t(),
                                   'gaussian'), ValueError),
           (splat_cuda.scatter, (fb, flat.int(), None, col), TypeError),
           (splat_cuda.scatter, (fb, flat, flat.bool()[:4], col), ValueError),
           (splat_cuda.scatter, (fb, flat, None, col[:, :2].contiguous()),
            ValueError)]
    for fn, args, err in bad:
        with pytest.raises(err):
            fn(*args)
