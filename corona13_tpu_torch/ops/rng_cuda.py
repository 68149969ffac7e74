"""The counter RNG's draw as one CUDA kernel a call.

``ops/rng.py`` hashes the (pixel, sample, dim, seed) counter with eager
int64 torch ops: 52 launches a draw over the whole wavefront, moving 932
bytes a lane.  ``csrc/rng.cu`` hashes each lane in uint32 registers: one
launch, 16 bytes read and 4 written a lane, and the torch path's bits
(the source says why they agree).

``rng.uniform`` launches it for every draw whose pixel ids are a CUDA
tensor.  ``_operands`` brings the four counter words to the forms the
kernel reads, as ``rng._words`` broadcasts them: a Python int stays a
word of the arguments, masked to 32 bits here; a tensor becomes int64 on
the pixel's card, and over the lanes of the broadcast shape either one
value for every lane (step 0) or a contiguous value a lane (step 1).
The wavefront's draws (a contiguous int64 pixel beside an int64 sample
or a Python int) pass as they are; other forms (kmlt's [C, 1] x [1, D]
broadcasts, int32 ids, strided views) cost a cast or a copy first.

Build and launch: ``ops/cuda_lib.py`` (entry ``corona13_rng_uniform``,
``_build/librng_<hash>.so``), at the first draw on the card.
``tracing.launches`` counts 'rng_uniform'.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

M32 = 0xFFFFFFFF
MAX_LANES = 1 << 30


class _Args(cuda_lib.Args):
    """Corona13RngArgs of csrc/rng.cu, field for field."""
    _p, _i, _u = cuda_lib.PTR, cuda_lib.INT, cuda_lib.UINT
    _fields_ = [
        ('n', _i), ('pixel_step', _i), ('sample_step', _i), ('dim_step', _i),
        ('seed_step', _i), ('pixel_word', _u), ('sample_word', _u),
        ('dim_word', _u), ('seed_word', _u), ('pixel', _p), ('sample', _p),
        ('dim', _p), ('seed', _p), ('out', _p), ('stream', _p)]


def build():
    """``csrc/rng.cu``'s entry, built and loaded once a process
    (``cuda_lib.load``)."""
    return cuda_lib.load('rng', 'rng_cuda.build', 'corona13_rng_uniform',
                         _Args)


def _operands(pixel, sample, dim, seed):
    """The draw's lanes' shape, and each counter word as the kernel reads
    it: (None, 0, the word masked to 32 bits) for a Python int, else
    (an int64 tensor on pixel's device, step, 0) with step 0 where the
    tensor holds one value for every lane and 1 where it holds a value a
    lane, contiguous."""
    dev = pixel.device
    words = [x if isinstance(x, int) or (isinstance(x, torch.Tensor)
                                         and x.device == dev)
             else torch.as_tensor(x, device=dev)
             for x in (pixel, sample, dim, seed)]
    # the wavefront's words share one shape (broadcast_shapes is slow)
    shapes = {x.shape for x in words if not isinstance(x, int)}
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(
        *shapes)
    n = math.prod(shape)
    out = []
    for x in words:
        if isinstance(x, int):
            out.append((None, 0, x & M32))
            continue
        if x.dtype != torch.int64:
            x = x.to(torch.int64)
        if x.numel() != 1:
            if x.shape != shape:
                x = x.expand(shape)
            if x.dim() != 1:
                x = x.reshape(n)        # a view where it can be, else a copy
            if x.stride(0) == 0:
                x = x[:1]
        if x.numel() == 1:
            out.append((x, 0, 0))
        else:
            out.append((x.contiguous(), 1, 0))
    return shape, out


def uniform(pixel, sample, dim, seed) -> torch.Tensor:
    """``rng.uniform(pixel, sample, dim, seed)`` in one launch: float32 of
    the broadcast shape on pixel's card.  A pixel that is no CUDA tensor,
    or more than ``MAX_LANES`` lanes, raises ValueError before any
    build."""
    if not isinstance(pixel, torch.Tensor) or not pixel.is_cuda:
        raise ValueError('rng_cuda: pixel is not a CUDA tensor')
    shape, words = _operands(pixel, sample, dim, seed)
    n = math.prod(shape)
    if n >= MAX_LANES:
        raise ValueError(f'rng_cuda: {n} lanes in one launch')
    out = torch.empty(shape, dtype=torch.float32, device=pixel.device)
    if n == 0:
        return out
    steps, ints, ptrs = zip(*[(step, word, None if x is None else
                               x.data_ptr()) for x, step, word in words])
    a = _Args(n, *steps, *ints, *ptrs, out.data_ptr())   # field order
    cuda_lib.launch(build(), a, pixel.device, 'rng_cuda', 'rng_uniform')
    return out
