"""The port's one square root, correctly rounded on every device.

torch's vectorized float32 ``sqrt`` on the CPU is not correctly rounded:
on a large tensor about 0.6% of its roots are one ulp low (a tensor of a
few dozen elements hides it).  numpy's root, the JAX package's ``jnp.sqrt``
and the traversal kernel's ``sqrtf`` (nvcc ``-prec-sqrt=true``) are
correctly rounded.  ``utils.math.sqrt`` rounds correctly on the CPU
(through a double) and every root the port takes of a tensor comes
through it; ``utils.math.rsqrt`` divides one by it.  These tests hold, on
the CPU:

- ``sqrt`` to ``np.sqrt`` bit for bit on 2^20 float32 inputs of each range
  of exponents, subnormals included, and on the special values (NaN
  compared as NaN);
- ``rsqrt`` to ``torch.rsqrt`` bit for bit (the CPU's bits do not move)
  and to numpy's ``1 / sqrt``;
- the gradient of ``sqrt`` to ``0.5 / sqrt(x)`` within one ulp;
- the port's sources: no root of a tensor outside ``utils/math.py``, and
  the kernel built with IEEE roots and divisions.

On the card ``chip_smoke.py``'s rounding phase holds the CUDA branch to the
CPU's and to numpy's on 2^24 inputs.
"""

import os
import re

import numpy as np
import pytest
import torch

from corona13_tpu_torch.ops import cuda_lib
from corona13_tpu_torch.utils import math as tmath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, 'corona13_tpu_torch')
N = 1 << 20

# float32 bit patterns [lo, hi) by exponent: every exponent of each range
# is drawn about equally often
RANGES = {
    'subnormal': (0x00000001, 0x00800000),
    '2^-126..2^-64': (0x00800000, 0x1f800000),
    '2^-64..1': (0x1f800000, 0x3f800000),
    '1..2^64': (0x3f800000, 0x5f800000),
    '2^64..max': (0x5f800000, 0x7f800000),
    'all finite': (0x00000000, 0x7f800000),
}
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -1e-45, 1e-45,
                    1.1754942e-38, 1.1754944e-38, 3.4028235e38, 1.0, 2.0,
                    4.0, 0.25, 0.5, 3.0], np.float32)


def _inputs(name):
    if name == 'special':
        # long enough for the vectorized loops, with a random tail
        rest = np.random.default_rng(16).integers(
            0x3f800000, 0x5f800000, N, dtype=np.uint32).view(np.float32)
        return np.concatenate([np.tile(SPECIAL, 64), rest])
    lo, hi = RANGES[name]
    seed = 17 + list(RANGES).index(name)
    return np.random.default_rng(seed).integers(lo, hi, N, dtype=np.uint32) \
        .view(np.float32)


def _same(a, b):
    """Bit for bit, a NaN of any sign or payload equal to a NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return (a.view(np.uint32) == b.view(np.uint32)) | nan


@pytest.mark.parametrize('name', [*RANGES, 'special'])
def test_sqrt_is_correctly_rounded(name):
    x = _inputs(name)
    with np.errstate(invalid='ignore'):
        want = np.sqrt(x)
    got = tmath.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    same = _same(got.numpy(), want)
    assert same.all(), (int((~same).sum()), x[~same][:8])


@pytest.mark.parametrize('name', [*RANGES, 'special'])
def test_rsqrt_keeps_the_cpu_bits(name):
    x = _inputs(name)
    t = torch.from_numpy(x)
    got = tmath.rsqrt(t).numpy()
    same = _same(got, torch.rsqrt(t).numpy())
    assert same.all(), (int((~same).sum()), x[~same][:8])
    with np.errstate(invalid='ignore', divide='ignore'):
        want = np.float32(1.0) / np.sqrt(x)
    assert _same(got, want).all()


def test_sqrt_gradient_within_one_ulp():
    """Autograd through the double route: d sqrt(x) / dx against 0.5 /
    sqrt(x) computed in float64 and rounded once, on normal inputs from
    2^-120 to 2^120."""
    x = np.random.default_rng(23).integers(
        0x03800000, 0x7b800000, N, dtype=np.uint32).view(np.float32)
    t = torch.from_numpy(x.copy()).requires_grad_()
    tmath.sqrt(t).sum().backward()
    assert t.grad.dtype == torch.float32
    want = (0.5 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    ulps = np.abs(t.grad.numpy().view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


# a root of a tensor: torch's own functions, a method, a half power (math
# and numpy roots, correctly rounded already, stay)
_ROOT = re.compile(
    r'torch\.(sqrt|rsqrt|hypot)\b|torch\.linalg\.(vector_)?norm\b'
    r'|(?<!math)(?<!np)\.(sqrt|rsqrt)\(|\.norm\('
    r'|\*\*\s*\(?\s*0?\.5\b|\bpow\([^)]*,\s*0?\.5\s*\)'
    r'|\.(float_)?pow_?\(\s*0?\.5\s*\)|\bfloat_power\(')


@pytest.mark.parametrize('line', [
    'r = torch.sqrt(x)', 'r = x.sqrt()', 'r = torch.rsqrt(x)',
    'r = x.rsqrt()', 'r = torch.linalg.norm(v, dim=-1)', 'r = v.norm(dim=-1)',
    'r = torch.hypot(a, b)', 'r = x ** 0.5', 'r = x ** (0.5)',
    'r = torch.pow(x, 0.5)', 'r = x.pow(0.5)', 'r = x.pow_(.5)',
    'r = torch.float_power(x, 0.5)', 'r = x.float_power(0.5)'])
def test_root_pattern_flags(line):
    """Each way of writing a root of a tensor is one the scan finds."""
    assert _ROOT.search(line), line


@pytest.mark.parametrize('line', [
    'r = math.sqrt(2.0)', 'r = np.sqrt(x)', 'r = x.pow(2)',
    'r = torch.pow(x, 1.0 / 2.4)', 'r = x ** 2'])
def test_root_pattern_passes(line):
    """Host roots (correctly rounded already) and other powers pass."""
    assert not _ROOT.search(line), line


def test_no_root_outside_the_helper():
    found = []
    for base, _, files in os.walk(PACKAGE):
        for f in files:
            path = os.path.join(base, f)
            rel = os.path.relpath(path, PACKAGE)
            if not f.endswith('.py') or rel == os.path.join('utils',
                                                            'math.py'):
                continue
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if _ROOT.search(line.replace('np.linalg.norm(', '')):
                        found.append(f'{rel}:{i}: {line.strip()}')
    assert not found, '\n'.join(found)


def test_kernel_rounds_as_ieee():
    """The kernel's roots and divisions: nvcc's IEEE defaults stated in
    the flags (which name the built library), no fast-math, and no
    approximate intrinsic in the source."""
    flags = cuda_lib.NVCC_FLAGS
    for f in ('-prec-sqrt=true', '-prec-div=true', '-ftz=false',
              '-fmad=false'):
        assert f in flags
    assert not any('fast_math' in f or 'fast-math' in f for f in flags)
    with open(os.path.join(PACKAGE, 'csrc', 'traverse_tris.cu')) as fh:
        src = fh.read()
    assert 'sqrtf(' in src
    for approx in ('rsqrtf(', '__fsqrt', '__frsqrt', '__fdividef', '__frcp',
                   '__fdiv_r', '__powf', '__expf'):
        assert approx not in src, approx
