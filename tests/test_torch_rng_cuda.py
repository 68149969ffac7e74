"""The counter RNG's kernel (``ops/rng_cuda.py``, ``csrc/rng.cu``) and its
dispatch in ``ops/rng.py``, on the CPU (tier 1); the card's tests are in
``tests/test_torch_gpu.py``.

- CPU tensors take the torch path (``rng.uniform_plain``) with its bits;
  every draw on a card's pixel goes to the kernel;
- the kernel's rounds, written out in numpy uint32 (only v0 of the second
  round), give the torch path's bits over edge words (0, 2^32 - 1,
  negative Python ints and ids, seeds and ids at or above 2^32) and over
  random words, with the sample as ids a lane and as one id;
- every form of the inputs (kmlt's 2-D broadcasts, tensor dims and
  seeds, int32 ids, strided views, numpy words), brought to the kernel's
  operands by the binding and hashed by those rounds, gives the torch
  path's bits; the wavefront's forms pass without a copy;
- the ctypes binding against the C struct, the source's CUDA runtime
  calls (none synchronises) and intrinsics, the wrapper's checks before
  the build, the set-up span and the launch key.
"""

import os
import re

import numpy as np
import pytest
import torch

from corona13_tpu_torch import tracing
from corona13_tpu_torch.ops import cuda_lib, rng, rng_cuda

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'corona13_tpu_torch')
M32 = 0xFFFFFFFF
EDGE = [0, 1, 0x7FFFFFFF, 0x80000000, M32, 1 << 32, (1 << 32) + 5, -1, -2,
        -(1 << 31), 0x9E3779B9, 0x5BD1E995, (1 << 62) + 3]


def _word(x):
    """An id or a Python int as the kernel reads it: its low 32 bits."""
    return np.asarray(np.asarray(x, dtype=object) & M32).astype(np.uint32)


def _kernel_model(pixel, sample, dim, seed):
    """csrc/rng.cu's rounds in numpy uint32 over the lanes of ``pixel``
    (the other words broadcast to them): [N] float32."""
    with np.errstate(over='ignore'):
        lcg = lambda v: v * np.uint32(1664525) + np.uint32(1013904223)
        n = len(pixel)
        v0 = lcg(_word(pixel))
        v1 = lcg(np.broadcast_to(_word(sample), (n,)))
        v2 = lcg(np.broadcast_to(_word(dim), (n,)))
        v3 = lcg(np.broadcast_to(_word(seed) ^ np.uint32(0x9E3779B9), (n,)))
        v0 = v0 + v1 * v3
        v1 = v1 + v2 * v0
        v2 = v2 + v0 * v1
        v3 = v3 + v1 * v2
        v0 = v0 ^ (v0 >> np.uint32(16))
        v1 = v1 ^ (v1 >> np.uint32(16))
        v3 = v3 ^ (v3 >> np.uint32(16))
        v0 = v0 + v1 * v3
    return (v0 >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _ids(values):
    """int64 ids holding ``values`` (Python ints) as their two's
    complement low 64 bits."""
    return torch.tensor([((v + (1 << 63)) % (1 << 64)) - (1 << 63)
                         for v in values], dtype=torch.int64)


@pytest.mark.parametrize('dim', [0, 7, 0x7fffffff, M32, -3, 1 << 33])
@pytest.mark.parametrize('seed', [0, 12345, M32, -1, (1 << 32) + 0x9e37,
                                  0x1234 + 0x9e37 + (7 << 32)])
def test_model_has_the_torch_paths_bits_on_edge_words(dim, seed):
    """Every pair of edge ids as (pixel, sample): the model's floats are
    the torch path's, bit for bit."""
    pix = [p for p in EDGE for _ in EDGE]
    smp = [s for _ in EDGE for s in EDGE]
    want = rng.uniform_plain(_ids(pix), _ids(smp), dim, seed).numpy()
    got = _kernel_model(pix, smp, dim, seed)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for s in (0, 3, M32, -1, 1 << 40):      # one sample id for every lane
        want = rng.uniform_plain(_ids(pix), s, dim, seed).numpy()
        np.testing.assert_array_equal(
            _bits(_kernel_model(pix, s, dim, seed)), _bits(want))


def test_model_has_the_torch_paths_bits_on_random_words():
    g = np.random.default_rng(24)
    n = 1 << 16
    pix = g.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    pix[: n // 2] &= M32                    # the ids a wavefront holds
    smp = g.integers(0, 1 << 32, n, dtype=np.int64)
    for dim, seed in [(int(d), int(s)) for d, s in zip(
            g.integers(0, 1 << 40, 8), g.integers(-(1 << 40), 1 << 40, 8))]:
        want = rng.uniform_plain(torch.as_tensor(pix), torch.as_tensor(smp),
                                 dim, seed).numpy()
        got = _kernel_model(pix.tolist(), smp.tolist(), dim, seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert 0.0 <= want.min() and want.max() < 1.0


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: ``rng.uniform``'s
    dispatch reads ``is_cuda`` of the pixel alone."""
    is_cuda = True


def _forms():
    """(name, pixel, sample, dim, seed): the forms the port's draws take
    (the wavefront's 1-D draws, halton's per-pixel key, kmlt's [C, 1] x
    [1, D] broadcasts and scalar chains) and the others that broadcast."""
    pix = torch.arange(48, dtype=torch.int64) * 7919 - 5
    cid = torch.arange(6, dtype=torch.int64)
    dims = torch.arange(200, 208)
    return [
        ('wavefront', pix, pix * 3 + (1 << 33), rng.Dim.NEE_X + 303,
         (1 << 32) + 0x9e37),
        ('sample_int', pix, -4, 7, -9),
        ('sample_0dim', pix, torch.tensor(1 << 40), 7, 9),
        ('sample_expanded', pix, torch.tensor(7).expand(48), True, 0),
        ('halton_key', pix, 0, 0x7fffffff, 5),
        ('kmlt_draws', cid[:, None], torch.tensor(11), dims[None, :], 3),
        ('kmlt_init', cid[:, None], 17, torch.arange(100, 109)[None, :], 3),
        ('kmlt_chain', cid, 17 + 2, 9999, 3),
        ('tensor_seed', pix, pix, 5, torch.full((48,), -3)),
        ('int32_ids', pix.int(), pix.int().flip(0), 5, 1),
        ('strided', pix[::2], pix[1::2], 5, 1),
        ('column', torch.stack([pix, pix], 1)[:, 1], pix, 5, 1),
        ('pixel_0dim', torch.tensor(-7), pix, 5, 1),
        ('pixel_1x1', pix[:1, None], pix[None, :8], 5, 1),
        ('float_sample', pix, pix.float(), 5, 1),
        ('numpy_words', pix, np.int64(3), np.int32(5), np.uint32(M32)),
        ('three_dims', pix.reshape(2, 4, 6), torch.arange(6), 1, 2),
        ('empty', pix[:0], 0, 5, 1),
    ]


def _read(words, n):
    """The four counter words of ``rng_cuda._operands`` as the kernel reads
    them: [n] uint32 each."""
    lanes = np.arange(n)
    out = []
    for x, step, word in words:
        if x is None:
            assert step == 0
            out.append(np.full(n, word, np.uint32))
            continue
        assert x.dtype == torch.int64 and x.is_contiguous()
        assert step in (0, 1) and x.numel() == (n if step else 1)
        v = x.reshape(-1).numpy()[lanes * step]
        out.append((v & np.int64(M32)).astype(np.uint32))
    return out


@pytest.mark.parametrize('form', [f[0] for f in _forms()])
def test_operands_give_the_torch_paths_bits(form):
    """Every form brought to the kernel's operands (``_operands``) and
    hashed by the kernel's rounds gives uniform_plain's bits and shape."""
    _, *args = next(f for f in _forms() if f[0] == form)
    shape, words = rng_cuda._operands(*args)
    want = rng.uniform_plain(*args)
    assert tuple(shape) == tuple(want.shape)
    n = want.numel()
    got = _kernel_model(*_read(words, n)).reshape(tuple(shape))
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def test_wavefront_draws_pass_without_a_copy():
    """The wavefront's forms reach the kernel as they are: the same
    storage, no cast, no copy; a sample for every lane is read from one
    address."""
    pix = torch.arange(64, dtype=torch.int64)
    smp = pix * 3
    _, words = rng_cuda._operands(pix, smp, 5, 1)
    assert [w[0].data_ptr() for w in words[:2]] == [pix.data_ptr(),
                                                     smp.data_ptr()]
    assert [w[1] for w in words] == [1, 1, 0, 0]
    one = torch.tensor(7)
    for sample in (one, one.expand(64)):
        _, words = rng_cuda._operands(pix, sample, 5, 1)
        assert words[1][:2] == (words[1][0], 0)
        assert words[1][0].data_ptr() == one.data_ptr()


def test_wrapper_hands_the_kernel_its_operands(monkeypatch):
    """``rng_cuda.uniform`` fills the C struct from ``_operands`` in field
    order and launches once under 'rng_uniform' into the tensor it
    returns."""
    seen = []
    monkeypatch.setattr(rng_cuda, 'build', lambda: 'entry')
    monkeypatch.setattr(cuda_lib, 'launch', lambda *a: seen.append(a))
    pix = torch.arange(64, dtype=torch.int64).as_subclass(_OnCard)
    smp = torch.arange(64, dtype=torch.int64) * 3
    seed = torch.tensor(-3)
    out = rng_cuda.uniform(pix, smp, 5, seed)
    (fn, a, dev, who, key), = seen
    assert (fn, dev, who, key) == ('entry', pix.device, 'rng_cuda',
                                   'rng_uniform')
    assert out.shape == (64,) and out.dtype == torch.float32
    assert (a.n, a.out) == (64, out.data_ptr())
    assert (a.pixel, a.pixel_step) == (pix.data_ptr(), 1)
    assert (a.sample, a.sample_step) == (smp.data_ptr(), 1)
    assert (a.dim, a.dim_step, a.dim_word) == (None, 0, 5)
    assert (a.seed, a.seed_step) == (seed.data_ptr(), 0)
    out = rng_cuda.uniform(pix, 1 << 40 | 9, -2, (1 << 32) + 0x9e37)
    a = seen[-1][1]
    assert (a.sample, a.sample_word, a.dim_word, a.seed_word) == (
        None, 9, M32 - 1, 0x9e37)


def test_uniform_sends_every_card_draw_to_the_kernel(monkeypatch):
    """With the pixel on the card every form goes to the kernel's binding,
    the torch hash to none."""
    sent = []
    monkeypatch.setattr(rng_cuda, 'uniform', lambda *a: sent.append(a))

    def refuse(*a, **k):
        raise AssertionError('a card draw took the torch hash')
    monkeypatch.setattr(rng, 'uniform_plain', refuse)
    forms = _forms()
    for _, pixel, *rest in forms:
        rng.uniform(pixel.as_subclass(_OnCard), *rest)
    assert len(sent) == len(forms)


def test_cpu_never_reaches_the_kernel(monkeypatch):
    """On CPU tensors every form takes the torch path: rng.uniform and
    sample_dim give uniform_plain's bits with the kernel refused."""
    def refuse(*a, **k):
        raise AssertionError('the kernel was reached on the CPU')
    for name in ('build', 'uniform'):
        monkeypatch.setattr(rng_cuda, name, refuse)
    for _, *args in _forms():
        assert torch.equal(rng.uniform(*args), rng.uniform_plain(*args))
    pix = torch.arange(300, dtype=torch.int64) * 7919
    for kind in ('rand', 'halton'):
        assert torch.isfinite(rng.sample_dim(kind, pix, pix + 2, 3, 5)).all()


def test_sample_dim_routes_halton_pseed_through_uniform(monkeypatch):
    """halton's per-pixel scramble key is a draw through ``uniform`` (so
    the kernel's on the card); its digits stay on the torch path."""
    seen = []
    monkeypatch.setattr(rng, 'uniform', lambda *a: seen.append(a)
                        or rng.uniform_plain(*a))
    pix = torch.arange(16, dtype=torch.int64)
    rng.sample_dim('halton', pix, pix, 3, 5)
    assert [(a[1], a[2], a[3]) for a in seen] == [(0, 0x7fffffff, 5)]


def test_wrapper_rejects_bad_inputs_before_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('built before the checks')
    monkeypatch.setattr(rng_cuda, 'build', refuse)
    pix = torch.arange(8, dtype=torch.int64)
    for args in [(pix, pix, 1, 2), (pix.tolist(), 0, 1, 2),
                 (pix.numpy(), 0, 1, 2)]:
        with pytest.raises(ValueError, match='rng_cuda: pixel'):
            rng_cuda.uniform(*args)
    wide = torch.tensor(3).expand(rng_cuda.MAX_LANES).as_subclass(_OnCard)
    with pytest.raises(ValueError, match='rng_cuda: .* lanes'):
        rng_cuda.uniform(wide, 0, 1, 2)
    # no lanes: an empty draw, and nothing built or launched
    got = rng_cuda.uniform(pix[:0].as_subclass(_OnCard), 0, 1, 2)
    assert got.shape == (0,) and got.dtype == torch.float32


def test_binding_matches_the_c_struct():
    with open(os.path.join(PACKAGE, 'csrc', 'rng.cu')) as f:
        src = f.read()
    body = re.search(r'struct Corona13RngArgs \{(.*?)\};', src, re.S).group(1)
    fields = [name for decl in re.sub(r'//[^\n]*', '', body).split(';')
              for name in re.findall(r'(\w+)\s*(?:,|$)', decl.strip())]
    assert fields == [name for name, _ in rng_cuda._Args._fields_]
    kinds = {'int': cuda_lib.INT, 'unsigned int': cuda_lib.UINT}
    for decl, (name, ctype) in zip(
            [d.strip() for d in re.sub(r'//[^\n]*', '', body).split(';')
             if d.strip()], rng_cuda._Args._fields_):
        typ = decl.rsplit(' ', 1)[0]
        assert (ctype is cuda_lib.PTR) == typ.endswith('*'), decl
        if typ in kinds:
            assert ctype is kinds[typ], decl


def test_library_makes_no_synchronising_call():
    """The launch's host side calls only cudaGetLastError: no copy back,
    no synchronisation, no allocation; no fast-math intrinsic."""
    with open(os.path.join(PACKAGE, 'csrc', 'rng.cu')) as f:
        src = re.sub(r'//[^\n]*', '', f.read())
    assert set(re.findall(r'\b(cuda[A-Z]\w*)\s*\(', src)) == {
        'cudaGetLastError'}
    for approx in ('__expf', '__cosf', '__fdividef', '__frcp', '__fadd',
                   '__fmul', '__umul', '__mul24', 'fmaf('):
        assert approx not in src, approx
    assert '-fmad=false' in cuda_lib.NVCC_FLAGS


def test_setup_span_and_launch_key():
    assert 'rng_cuda.build' in tracing.SETUP_SPANS
    assert 'rng_cuda.build' in tracing.SPAN_NAMES
    assert tracing.launches['rng_uniform'] >= 0
    assert not hasattr(rng_cuda, 'launches')    # one launch registry
    before = dict(tracing.launches)
    rng.uniform(torch.arange(4), 0, 1, 2)
    assert tracing.launches == before           # nothing counted on the CPU
