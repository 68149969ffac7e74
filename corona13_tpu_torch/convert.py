"""Carry a JAX package scene over to the port.

``scene_from_numpy`` walks a ``corona13_tpu`` Scene duck-typed (dataclass
fields, ``np.asarray`` on every array leaf) without importing jax, and
returns the port's Scene on ``device``, so both packages can be fed the
very same BVH, packed leaves, materials, lights, camera and medium grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import scene as scene_mod
from .models import medium_hete
from .ops import trace as trace_mod
from .ops import trace_cuda

_CLASSES = {
    'Scene': scene_mod.Scene,
    'MaterialTable': scene_mod.MaterialTable,
    'LightTable': scene_mod.LightTable,
    'CameraP': scene_mod.CameraP,
    'DeviceGeometry': trace_mod.DeviceGeometry,
    'DeviceBVH': trace_mod.DeviceBVH,
    'VolGrid': medium_hete.VolGrid,
}
# int32 arrays the kernel reads as int32; every other int array becomes
# int64 (torch's index type)
_KEEP_INT32 = {'wlinks'}


def _leaf(name, x, device):
    a = np.asarray(x)
    if a.dtype == np.int32 and name not in _KEEP_INT32:
        a = a.astype(np.int64)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order='C'), device=device)


def scene_from_numpy(tree, device='cuda'):
    """Convert a JAX package Scene (or any of its component tables) to the
    port's dataclass of tensors on ``device`` (the card unless
    ``device='cpu'`` is passed)."""
    cls = _CLASSES.get(type(tree).__name__)
    if cls is None:
        raise TypeError(f'no port class for {type(tree).__name__}')
    ours = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for f in dataclasses.fields(tree):
        val = getattr(tree, f.name)
        if f.name not in ours:
            if val is not None:
                raise NotImplementedError(
                    f'{type(tree).__name__}.{f.name} is not ported yet')
            continue
        if val is None or isinstance(val, (bool, int, float, str, tuple)):
            kw[f.name] = val
        elif dataclasses.is_dataclass(val):
            kw[f.name] = scene_from_numpy(val, device)
        else:
            kw[f.name] = _leaf(f.name, val, device)
    if cls is trace_mod.DeviceBVH and kw.get('wbounds') is not None:
        # the kernel's own layout is the port's: derive it from the wide one
        wb, wl, lp = (np.asarray(getattr(tree, k))
                      for k in ('wbounds', 'wlinks', 'leaf_packed'))
        kw.update(trace_mod.kernel_layout(
            wb, wl, lp, trace_cuda.wide_depth(wb, wl), device))
    return cls(**kw)
