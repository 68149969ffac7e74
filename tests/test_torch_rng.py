"""The port's counter RNG equals the JAX package's bit for bit.

Tolerance: none.  Both hash the same 32-bit words (the port in int64
masked to 32 bits), so every float is compared by its bit pattern.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corona13_tpu.ops import rng as jrng
from corona13_tpu_torch.ops import rng as trng


def _same_bits(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# the pixel ranges, samples, dims and seeds of tests/test_rng.py, plus the
# dims the path tracer draws (camera block, per-bounce salts, halton seed)
@pytest.mark.parametrize('n,sample,dim,seed', [
    (4096, 3, 7, 1), (4096, 3, 7, 2), (1 << 16, 0, 0, 0), (1 << 14, 0, 1, 0),
    (4096, 11, int(trng.Dim.LAMBDA), 0),
    (4096, 5, int(trng.Dim.RUSSIAN_R) + 101 * 5, 3),
    (4096, 0, 0x7fffffff, 9)])
def test_uniform_bits(n, sample, dim, seed):
    pix = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
    _same_bits(jrng.uniform(jnp.asarray(pix), sample, dim, seed),
               trng.uniform(torch.as_tensor(pix.astype(np.int64)), sample,
                            dim, seed))


def test_uniform2_bits():
    pix = np.arange(4096, dtype=np.uint32)
    smp = (np.arange(4096, dtype=np.uint32) * 7) % 513
    ja, jb = jrng.uniform2(jnp.asarray(pix), jnp.asarray(smp), 12, 4)
    ta, tb = trng.uniform2(torch.as_tensor(pix.astype(np.int64)),
                           torch.as_tensor(smp.astype(np.int64)), 12, 4)
    _same_bits(ja, ta)
    _same_bits(jb, tb)


@pytest.mark.parametrize('dim,seed', [(0, 7), (1, 7), (0, 1), (0, 9),
                                      (5, 0), (63, 3), (64, 3)])
def test_halton_bits(dim, seed):
    idx = np.arange(2 ** 10, dtype=np.uint32) * np.uint32(977)
    _same_bits(jrng.halton(jnp.asarray(idx), dim, seed=seed),
               trng.halton(torch.as_tensor(idx.astype(np.int64)), dim,
                           seed=seed))


@pytest.mark.parametrize('kind', ['rand', 'halton'])
@pytest.mark.parametrize('dim', [int(d) for d in (
    trng.Dim.IMAGE_X, trng.Dim.IMAGE_Y, trng.Dim.LAMBDA, trng.Dim.TIME,
    trng.Dim.APERTURE_X, trng.Dim.APERTURE_Y)] + [
        int(trng.Dim.OMEGA_X) + 101 * 3, int(trng.Dim.NEE_Y) + 101 * 12])
def test_sample_dim_bits(kind, dim):
    pix = np.arange(2048, dtype=np.uint32)
    smp = np.repeat(np.arange(4, dtype=np.uint32), 512)
    _same_bits(jrng.sample_dim(kind, jnp.asarray(pix), jnp.asarray(smp), dim,
                               5),
               trng.sample_dim(kind, torch.as_tensor(pix.astype(np.int64)),
                               torch.as_tensor(smp.astype(np.int64)), dim, 5))
