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
from .ops import bvh as bvh_mod
from .ops import trace as trace_mod

_CLASSES = {
    'Scene': scene_mod.Scene,
    'MaterialTable': scene_mod.MaterialTable,
    'LightTable': scene_mod.LightTable,
    'CameraP': scene_mod.CameraP,
    'DeviceGeometry': trace_mod.DeviceGeometry,
    'DeviceBVH': trace_mod.DeviceBVH,
    'VolGrid': medium_hete.VolGrid,
}


def _leaf(x, device):
    """An array leaf as a tensor: int arrays become int64 (torch's index
    type), float64 float32."""
    a = np.asarray(x)
    if a.dtype == np.int32:
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
    if cls is trace_mod.DeviceBVH:
        # upload the JAX tree's own nodes and leaves again: the wide layout
        # and the kernel's records (which a JAX sphere or line BVH and its
        # moving triangles do not carry) come from the port's collapse8
        arr = lambda k: None if getattr(tree, k) is None else \
            np.asarray(getattr(tree, k))
        flat = bvh_mod.flat_from_nodes(arr('nodes'), arr('leaf_prims'))
        return cls.from_host(flat, arr('leaf_data'), arr('leaf_shade'),
                             arr('leaf_data_t1'), device=device)
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
            kw[f.name] = _leaf(val, device)
    return cls(**kw)
