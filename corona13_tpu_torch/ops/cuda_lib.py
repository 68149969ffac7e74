"""The hand-written CUDA kernels' build and launch, for every library.

A library is one ``csrc/<stem>.cu`` with a plain C entry that takes a
pointer to its ``Args`` struct (declared field for field by its binding:
``ops/trace_cuda.py``, ``hete_cuda.py``, ``splat_cuda.py``, ``rng_cuda.py``)
and returns the launch's ``cudaGetLastError``.  ``load`` compiles it once
a process, inside the binding's set-up span, into
``_build/lib<stem>_<hash>.so`` (the hash of the source and ``NVCC_FLAGS``:
an up-to-date library is reused).  ``launch`` runs an entry on torch's
current stream under the device guard, raises on a CUDA error and counts
the launch in ``tracing.launches``.
``check_tensors`` is the bindings' argument check.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from .. import tracing

# the field types of an Args struct (ctypes.Structure subclasses of Args)
Args, INT, UINT, LONG, FLOAT, PTR = (ctypes.Structure, ctypes.c_int,
                                     ctypes.c_uint, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_void_p)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
_BUILD = os.path.join(os.path.dirname(_CSRC), '_build')
# The rounding flags are nvcc's defaults, stated so that no later flag
# turns the kernels' sqrtf and divisions into approximations: the plain
# versions round as IEEE does (utils.math.sqrt), and so must the card.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-prec-sqrt=true', '-prec-div=true', '-ftz=false',
              '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')
build_logs = {}   # stem -> nvcc's report (registers, spills) on the library
_libs = {}        # stem -> the loaded library
_bound = {}       # (stem, entry) -> the bound C function


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ([os.path.join(home, 'bin', 'nvcc')] if home else []) + [
            shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('no nvcc to build the CUDA kernels with')


def compile_library(stem: str):
    """Compile ``csrc/<stem>.cu`` with ``NVCC_FLAGS`` into
    ``_build/lib<stem>_<hash>.so``, the hash of the source and the flags
    (an up-to-date library is reused), and load it with ctypes.  Returns
    the library and nvcc's report (registers, spills)."""
    src = os.path.join(_CSRC, f'{stem}.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha1(f.read() + repr(NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD, f'lib{stem}_{digest.hexdigest()[:12]}.so')
    if not os.path.exists(lib_path):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f'{lib_path}.{os.getpid()}.tmp'
        nvcc = _nvcc()
        tracing.note_kernel_build()
        out = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, src],
                             capture_output=True, text=True)
        log = out.stdout + out.stderr
        if out.returncode != 0:
            raise RuntimeError(f'{stem}: nvcc failed:\n{log}')
        with open(lib_path + '.log', 'w') as f:
            f.write(log)
        os.replace(tmp, lib_path)
    else:
        with open(lib_path + '.log') as f:
            log = f.read()
    return ctypes.CDLL(lib_path), log


def load(stem: str, span: str, entry: str, args, restype=INT):
    """The C function ``entry`` of ``csrc/<stem>.cu``, taking a pointer to
    the ``Args`` struct ``args`` (or, for a query such as a scratch size,
    one value of the field type ``args``) and returning ``restype``.  The
    library is compiled and loaded once a process, inside the set-up span
    ``span``; nvcc's report is kept in ``build_logs[stem]``."""
    fn = _bound.get((stem, entry))
    if fn is None:
        lib = _libs.get(stem)
        if lib is None:
            with tracing.setup_span(span):
                lib, build_logs[stem] = compile_library(stem)
            _libs[stem] = lib
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(args) if issubclass(args, Args)
                       else args]
        fn.restype = restype
        _bound[stem, entry] = fn
    return fn


def launch(fn, args, dev, who: str, key: str):
    """Run the entry ``fn`` (``load``) on ``args``: on torch's current
    stream of ``dev`` (into ``args.stream``), under its device guard.  A
    CUDA error raises, headed by ``who``; else the launch counts as
    ``key`` in ``tracing.launches``."""
    args.stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f'{who}: the kernel launch failed with CUDA '
                           f'error {err}')
    tracing.count_launch(key)


def check_tensors(want, dev, who: str):
    """Each (name, tensor, dtypes, shape or None): on ``dev``, of one of
    the dtypes, of that shape, contiguous.  ``who`` heads the message."""
    for name, x, dtypes, shape in want:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f'{who}: {name} is {type(x).__name__}, '
                            'needs a tensor')
        if x.device != dev:
            raise ValueError(f'{who}: {name} on {x.device}, rays on {dev}')
        if x.dtype not in dtypes:
            raise TypeError(f'{who}: {name} is {x.dtype}, '
                            f'needs {" or ".join(map(str, dtypes))}')
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f'{who}: {name} has shape '
                             f'{tuple(x.shape)}, needs {shape}')
        if not x.is_contiguous():
            raise ValueError(f'{who}: {name} is not contiguous')
