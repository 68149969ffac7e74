"""Counter-based stateless random numbers (corona13_tpu/ops/rng.py).

Every random number is a pure function of ``(pixel, sample_index,
dimension, seed)`` and equals the JAX package's bit for bit.  The JAX
code hashes in uint32; torch has no uint32 ``+`` or ``>>`` on every
device, so the hash state is carried in int64 and masked to its low 32
bits after every add and multiply.  An int64 product wraps mod 2^64, so
its low 32 bits are exact.  Pixel and sample ids are int64 tensors
holding values in [0, 2^32).

On the card, ``uniform`` hashes in one CUDA kernel a draw
(``ops/rng_cuda.py``, ``csrc/rng.cu``) with the same bits, whatever the
form of its inputs; ``uniform_plain`` is the torch hash, the kernel's
plain twin and the CPU's path.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from . import rng_cuda

M32 = 0xFFFFFFFF


class Dim(enum.IntEnum):
    """Named random dimensions, one block per path vertex (the reference's
    path_sample_dim_t, include/pathspace.h:16-53)."""
    # camera start block (7 dims)
    IMAGE_X = 0
    IMAGE_Y = 1
    LAMBDA = 2
    TIME = 3
    APERTURE_X = 4
    APERTURE_Y = 5
    CAMID = 6
    NUM_PT_BEG = 7
    # light start block (8 dims)
    ENVMAP_VS_AREA = 0
    LIGHTSOURCE = 1
    LIGHT_X = 4
    LIGHT_Y = 5
    EDF_X = 6
    EDF_Y = 7
    NUM_LT_BEG = 8
    # extend block (5 dims per bounce)
    FREE_PATH = 0
    OMEGA_X = 1
    OMEGA_Y = 2
    SCATTER_MODE = 3
    RUSSIAN_R = 4
    NUM_EXTEND = 5
    # next-event block (4 dims)
    NEE_LIGHT1 = 0
    NEE_LIGHT2 = 1
    NEE_X = 2
    NEE_Y = 3
    NUM_NEE = 4


def _pcg4d(v0, v1, v2, v3):
    """PCG4D hash (Jarzynski & Olano, JCGT 2020) on 32-bit words held in
    int64 tensors."""
    v0 = (v0 * 1664525 + 1013904223) & M32
    v1 = (v1 * 1664525 + 1013904223) & M32
    v2 = (v2 * 1664525 + 1013904223) & M32
    v3 = (v3 * 1664525 + 1013904223) & M32
    for shift in (True, False):
        v0 = (v0 + v1 * v3) & M32
        v1 = (v1 + v2 * v0) & M32
        v2 = (v2 + v0 * v1) & M32
        v3 = (v3 + v1 * v2) & M32
        if shift:
            v0 = v0 ^ (v0 >> 16)
            v1 = v1 ^ (v1 >> 16)
            v2 = v2 ^ (v2 >> 16)
            v3 = v3 ^ (v3 >> 16)
    return v0, v1, v2, v3


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1), using the top 24 bits."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _words(pixel, sample, dim, seed):
    """Broadcast the four counter words to one int64 shape."""
    pixel = torch.as_tensor(pixel)
    dev = pixel.device
    # a Python int becomes a tensor by a fill on the device: uploading it
    # from the host would synchronize the stream at every call
    args = [torch.full((), int(a) & M32, dtype=torch.int64, device=dev)
            if isinstance(a, int)
            else torch.as_tensor(a, device=dev).to(torch.int64) & M32
            for a in (pixel, sample, dim, seed)]
    return torch.broadcast_tensors(*args)


def uniform(pixel, sample, dim, seed=0) -> torch.Tensor:
    """One uniform float in [0,1) per element, from the (pixel, sample,
    dim, seed) counter.  All args broadcast; dim/seed may be python ints.
    One kernel launch where pixel is a CUDA tensor, else
    ``uniform_plain``."""
    if isinstance(pixel, torch.Tensor) and pixel.is_cuda:
        return rng_cuda.uniform(pixel, sample, dim, seed)
    return uniform_plain(pixel, sample, dim, seed)


def uniform_plain(pixel, sample, dim, seed=0) -> torch.Tensor:
    """``uniform`` as eager torch ops on any device."""
    z, s, d, k = _words(pixel, sample, dim, seed)
    v0, _, _, _ = _pcg4d(z, s, d, k ^ 0x9E3779B9)
    return _to_unit(v0)


def uniform2(pixel, sample, dim, seed=0):
    """Two independent uniforms (saves one hash vs calling uniform twice)."""
    z, s, d, k = _words(pixel, sample, dim, seed)
    v0, v1, _, _ = _pcg4d(z, s, d, k ^ 0x9E3779B9)
    return _to_unit(v0), _to_unit(v1)


# --- scrambled Halton (QMC point sampler) -----------------------------------

_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
], dtype=np.uint32)
MAX_HALTON_DIM = len(_PRIMES)
# number of base-b digits needed to exhaust 32-bit indices, per base
_NDIGITS = np.ceil(32.0 / np.log2(_PRIMES.astype(np.float64))).astype(np.int32)


def halton(index, dim: int, seed=0) -> torch.Tensor:
    """Owen-style scrambled radical inverse of ``index`` in the ``dim``-th
    prime base; digit permutations are hashed per (dim, digit, seed)."""
    if dim >= MAX_HALTON_DIM:
        return uniform(index, 0, dim, seed)
    b = int(_PRIMES[dim])
    nd = int(_NDIGITS[dim])
    idx = torch.as_tensor(index).to(torch.int64) & M32
    dev = idx.device
    seed_w = torch.broadcast_to(
        torch.as_tensor(seed, device=dev).to(torch.int64) & M32, idx.shape)
    out = torch.zeros(idx.shape, dtype=torch.float32, device=dev)
    inv = float(np.float32(1.0 / b))
    scale = torch.full(idx.shape, inv, dtype=torch.float32, device=dev)
    for digit_pos in range(nd):
        digit = idx % b
        idx = idx // b
        h0, h1, _, _ = _pcg4d(torch.full_like(idx, dim),
                              torch.full_like(idx, digit_pos), seed_w,
                              torch.full_like(idx, 0x5bd1e995))
        a = h0 % (b - 1) + 1
        c = h1 % b
        sd = (digit * a + c) % b
        out = out + sd.to(torch.float32) * scale
        scale = scale * inv
    return torch.clamp(out, max=float(np.float32(1.0 - 2 ** -24)))


def sample_dim(kind: str, pixel, sample, dim: int, seed=0):
    """Dispatch between point samplers ('rand' hash or 'halton' QMC)."""
    if kind == 'halton':
        pseed = uniform(pixel, 0, 0x7fffffff, seed)  # per-pixel scramble key
        pseed = (pseed * (2.0 ** 31)).to(torch.int64)
        return halton(sample, dim, seed=pseed)
    return uniform(pixel, sample, dim, seed)
