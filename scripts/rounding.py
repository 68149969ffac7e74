"""How the port's square roots round, and whether the kernel's flags move them.

    python3 scripts/rounding.py cpu [--jax]   # on the CPU
    python3 scripts/rounding.py flags         # where nvcc is (the card's host)

``cpu`` counts, on float32 inputs made from a seed, the roots that differ
from numpy's (correctly rounded) root: torch's ``sqrt`` on 1,000,000
values uniform in [0, 1000) and on 10,000,000 of ``torch.rand * 1e3``, on
the first 64 and 1,000 of them, ``torch.pow(x, 0.5)``, the root of the
double rounded to float32, and ``utils.math.sqrt``; how many of the
differing roots are one ulp low; ``torch.rsqrt`` and ``utils.math.rsqrt``
against ``1 / sqrt_rn`` (numpy's division of one by numpy's root).  With
``--jax`` also the JAX package's ``jnp.sqrt`` (eager and under ``jit``) and
``lax.rsqrt`` on the CPU (JAX is imported by this option only).

``flags`` builds ``corona13_tpu_torch/csrc/traverse_tris.cu`` twice, with
``cuda_lib.NVCC_FLAGS`` and with the same flags less the explicit
rounding ones (``-prec-sqrt=true -prec-div=true -ftz=false``, nvcc's
defaults), and compares each kernel's ptxas registers and the hash of its
SASS (``cuobjdump -sass``).  The build goes to a temporary directory.

The last line is a JSON object of the counts.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import differ_bits  # noqa: E402

ROUNDING_FLAGS = ('-prec-sqrt=true', '-prec-div=true', '-ftz=false')


def cpu_counts(with_jax):
    from corona13_tpu_torch.utils import math as tmath
    x = (np.random.default_rng(0).random(1_000_000) * 1000).astype(np.float32)
    t = torch.from_numpy(x)
    rn = np.sqrt(x)
    low = torch.sqrt(t).numpy()
    one_low = int((low.view(np.int32) == rn.view(np.int32) - 1).sum())
    g = torch.Generator().manual_seed(0)
    big = torch.rand(10_000_000, generator=g) * 1e3
    inv = np.float32(1.0) / rn
    out = {
        'torch.sqrt, 1e6 uniform [0, 1000)': differ_bits(low, rn),
        'of which one ulp low': one_low,
        'torch.sqrt, 1e7 torch.rand * 1e3': differ_bits(
            torch.sqrt(big).numpy(), np.sqrt(big.numpy())),
        'torch.sqrt, the first 64': differ_bits(torch.sqrt(t[:64].clone()),
                                            rn[:64]),
        'torch.sqrt, the first 1000': differ_bits(torch.sqrt(t[:1000].clone()),
                                              rn[:1000]),
        'torch.pow(x, 0.5)': differ_bits(torch.pow(t, 0.5), rn),
        'torch.sqrt(x.double()).float()': differ_bits(
            torch.sqrt(t.double()).float(), rn),
        'utils.math.sqrt': differ_bits(tmath.sqrt(t), rn),
        'torch.rsqrt against 1 / sqrt_rn': differ_bits(torch.rsqrt(t), inv),
        'utils.math.rsqrt against 1 / sqrt_rn': differ_bits(tmath.rsqrt(t), inv),
        'utils.math.rsqrt against torch.rsqrt': differ_bits(tmath.rsqrt(t),
                                                        torch.rsqrt(t)),
    }
    if with_jax:
        import jax
        import jax.numpy as jnp
        jax.config.update('jax_platforms', 'cpu')
        out['jnp.sqrt'] = differ_bits(jnp.sqrt(x), rn)
        out['jnp.sqrt under jit'] = differ_bits(jax.jit(jnp.sqrt)(x), rn)
        out['lax.rsqrt against 1 / sqrt_rn'] = differ_bits(jax.lax.rsqrt(x), inv)
    for k, v in out.items():
        print(f'{k}: {v}', flush=True)
    return {'torch': torch.__version__,
            'cpu_capability': torch.backends.cpu.get_cpu_capability(),
            'counts': out}


def _build(nvcc, flags, src, out_dir):
    lib = os.path.join(out_dir, 'lib.so')
    res = subprocess.run([nvcc, *flags, '-o', lib, src], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed:\n{res.stdout}{res.stderr}')
    regs, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and 'registers' in line:
            regs[name] = line.split(':', 1)[-1].strip()
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), 'cuobjdump'),
                           '-sass', lib], capture_output=True, text=True,
                          check=True).stdout
    hashes, name, body = {}, None, []
    for line in sass.splitlines() + ['Function : <end>']:
        m = re.search(r'Function : (\S+)', line)
        if m:
            if name:
                hashes[name] = hashlib.sha1(
                    '\n'.join(body).encode()).hexdigest()[:16]
            name, body = m.group(1), []
        elif name:
            body.append(line.strip())
    return regs, hashes


def flag_counts():
    from corona13_tpu_torch.ops import cuda_lib
    new = cuda_lib.NVCC_FLAGS
    old = tuple(f for f in new if f not in ROUNDING_FLAGS)
    src = os.path.join(HERE, 'corona13_tpu_torch', 'csrc', 'traverse_tris.cu')
    nvcc = cuda_lib._nvcc()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        dirs = [os.path.join(tmp, d) for d in ('old', 'new')]
        for d in dirs:
            os.makedirs(d)
        (r_old, h_old), (r_new, h_new) = pool.map(
            lambda a: _build(nvcc, *a), [(old, src, dirs[0]),
                                         (new, src, dirs[1])])
    print(f'without {" ".join(ROUNDING_FLAGS)}: {len(h_old)} kernels; '
          f'with: {len(h_new)}', flush=True)
    for k in sorted(h_new):
        print(f'  {k[:60]}: registers {r_old.get(k)} -> {r_new.get(k)}; '
              f'SASS {h_old.get(k)} -> {h_new[k]}', flush=True)
    same_regs = sum(r_old.get(k) == v for k, v in r_new.items())
    same_sass = sum(h_old.get(k) == v for k, v in h_new.items())
    print(f'registers equal on {same_regs} of {len(r_new)} kernels, SASS '
          f'equal on {same_sass} of {len(h_new)}', flush=True)
    return {'kernels': len(h_new), 'registers_equal': same_regs,
            'sass_equal': same_sass, 'old_flags': ' '.join(old),
            'new_flags': ' '.join(new)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('mode', choices=('cpu', 'flags'))
    ap.add_argument('--jax', action='store_true')
    args = ap.parse_args()
    out = cpu_counts(args.jax) if args.mode == 'cpu' else flag_counts()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
