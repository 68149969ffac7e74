"""Find the operations where the card's paths leave the CPU's.

    python3 scripts/bisect_vs_cpu.py [--cells spheres,hair_thin]

For each cell of ``chip_smoke.vs_cpu_cells`` (its scene, size and
settings, as chip_smoke.paths_against_cpu compares them; the sky's
envmap fitted on the card) runs ``pt.sample_paths`` once on the card
under a torch function mode that runs every torch call as asked and then
again on CPU copies of its own inputs, and holds the two results to each
other (values equal, a NaN equal to a NaN; the sign of a zero is not
compared).  A call that differs on the same inputs is an operation that
rounds apart on the two devices.  The traversal kernels are launched
through ctypes, not torch, so they are not replayed here (chip_smoke.py
holds each to its plain version).  Prints the share of paths that agree
as chip_smoke prints it, then every (operation, the port's source line
that called it) that differed: its calls, the calls that differed, and the elements that
differed of those it produced (for ``sort``, the indices of equal keys
count too).  A ``torch.sqrt`` on the card is replayed through the port's
CPU branch (``utils.math.sqrt``), as the port computes it there.
In-place calls and reads of a tensor's metadata are not replayed.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import os
import sys
import traceback

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from corona13_tpu_torch.utils import math as tmath  # noqa: E402
PACKAGE = os.path.join(HERE, 'corona13_tpu_torch')
_NOT_REPLAYED = {'__get__', '__set__', '__setitem__', 'to', 'cpu', 'cuda',
                 'numpy', 'item', 'tolist', 'data_ptr', 'size', 'dim',
                 'numel', 'element_size', 'is_floating_point', 'is_complex',
                 'contiguous', 'clone', 'detach', '__len__', '__bool__',
                 '__format__', '__repr__', '__hash__', '__int__', '__float__',
                 '__index__', 'storage_offset', 'stride', 'untyped_storage',
                 'record_stream', 'is_contiguous', 'requires_grad_'}


# the port's CPU branch of a torch call it makes on the card alone:
# utils.math.sqrt takes torch.sqrt of a float32 tensor only on CUDA
_CPU_TWIN = {torch.sqrt: tmath.sqrt}


def moved(x, dev):
    """``x`` with every tensor in it on ``dev`` (dataclasses, tuples,
    lists and dicts walked)."""
    if torch.is_tensor(x):
        return x.detach().to(dev)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: moved(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*(moved(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(moved(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: moved(v, dev) for k, v in x.items()}
    if isinstance(x, torch.device) and x.type == 'cuda':
        return torch.device(dev)
    return x


def tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))


def _differ(a, b):
    """Elements of two results whose values differ (NaN equal to NaN)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return None
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return int((~same).sum())


def _caller():
    """The innermost frame of the port that made the call."""
    for f in reversed(traceback.extract_stack()):
        if f.filename.startswith(PACKAGE):
            return f'{os.path.relpath(f.filename, HERE)}:{f.lineno}'
    return '?'


class Replay(TorchFunctionMode):
    """Every torch call on the card, again on the CPU on the same inputs."""

    def __init__(self):
        super().__init__()
        # (op, caller) -> [calls, calls differing, elements differing,
        # elements]
        self.ops = collections.OrderedDict()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, '__name__', repr(func))
        if (name in _NOT_REPLAYED or name.startswith('__i')
                or (name.endswith('_') and not name.endswith('__'))
                or not any(t.is_cuda for t in tensors((args, kwargs)))):
            return out
        try:
            ref = _CPU_TWIN.get(func, func)(*moved(args, 'cpu'),
                                            **moved(kwargs, 'cpu'))
        except (RuntimeError, TypeError, ValueError, IndexError):
            return out
        got, want = list(tensors(out)), list(tensors(ref))
        if len(got) != len(want):
            return out
        counts = [_differ(a, b) for a, b in zip(got, want)]
        if None in counts:
            return out
        row = self.ops.setdefault((name, _caller()), [0, 0, 0, 0])
        row[0] += 1
        row[1] += any(counts)
        row[2] += sum(counts)
        row[3] += sum(t.numel() for t in got)
        return out


def bisect(name, cell, env, dev):
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch.samplers import pt as pt_mod
    _, build, w, h, _, cfg_kw = cell
    cfg = pt_mod.PTConfig(width=w, height=h, mf=4, use_nee=True, **cfg_kw)
    scenes = [scene_mod.fit_film(build(d, env), w, h)
              for d in (dev, torch.device('cpu'))]
    with torch.no_grad():
        cpu = pt_mod.sample_paths(scenes[1], cfg, 5, torch.arange(w * h))[0]
        replay = Replay()
        with replay:
            card = pt_mod.sample_paths(scenes[0], cfg, 5,
                                       torch.arange(w * h, device=dev))[0]
    close = float(np.isclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-4,
                             atol=1e-6).all(axis=-1).mean())
    rows = [dict(op=op, at=at, calls=c, calls_differ=cd, elements_differ=ed,
                 elements=e) for (op, at), (c, cd, ed, e) in replay.ops.items()]
    differ = [r for r in rows if r['calls_differ']]
    print(f'== {name}: paths agreeing at rtol 1e-4 / atol 1e-6 {close:.4f}; '
          f'{sum(r["calls"] for r in rows)} calls replayed on the CPU, '
          f'{len(differ)} of {len(rows)} call sites differ on the same '
          f'inputs (in the order first called):', flush=True)
    for r in differ:
        print(f'  {r["op"]} at {r["at"]}: {r["calls_differ"]} of '
              f'{r["calls"]} calls, {r["elements_differ"]} of '
              f'{r["elements"]} elements', flush=True)
    return dict(paths=close, differ=differ, sites=len(rows))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cells', default='spheres,hair_thin')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this script needs a GPU')
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cells, dev = cs.vs_cpu_cells(), torch.device('cuda')
    res = {c: bisect(c, cells[c], cs.sky_env(dev) if c == 'sky' else None,
                     dev)
           for c in args.cells.split(',') if c}
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
