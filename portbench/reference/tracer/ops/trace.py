# Frozen copy of corona13_tpu_torch/ops/trace.py (lines 1-402) as of commit 2084081, for the benchmark's plain reference.
# Kept: triangle scenes, static and moving (the benchmark's cells); dropped: sphere and line geometry, the kernel's records, the deep-tree layout.
"""Wavefront ray intersection of triangle scenes (corona13_tpu/ops/trace.py).

Static triangles take the wide (BVH8) walk with the TPU kernel's winner,
triangles lerped at the ray ``time`` on a moving scene, and a tree too
deep for the wide stack, the skip-link walk (``trace_cuda``'s plain
versions).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bvh as bvh_mod
from . import trace_cuda

INVALID_PRIM = -1
MAX_DIST = 3.4e38


@dataclasses.dataclass
class DeviceBVH:
    nodes: torch.Tensor       # [n_nodes, 8] f32: min3, max3, i32 skip, i32 first
    leaf_prims: torch.Tensor  # [slots] int64 prim ids, padded with -1
    leaf_data: torch.Tensor   # [slots, 9] packed (v0, e1, e2) per slot
    leaf_shade: torch.Tensor  # [slots, 17] vn(9), uv(6), shader, quad_half
    # wide (BVH8) layout of the static walk (None when the tree is empty
    # or too deep for the kernel's stack)
    wbounds: torch.Tensor | None = None      # [Wn, 8, 8] f32
    wlinks: torch.Tensor | None = None       # [Wn*8] i32
    leaf_packed: torch.Tensor | None = None  # [n_leaves, 8, 16] f32
    leaf_data_t1: torch.Tensor | None = None  # [slots, 9] shutter close

    @classmethod
    def from_host(cls, b: bvh_mod.FlatBVH, leaf_data: np.ndarray,
                  leaf_shade: np.ndarray,
                  leaf_data_t1: np.ndarray | None = None, *,
                  device) -> 'DeviceBVH':
        packed = np.concatenate([
            b.node_min, b.node_max,
            b.node_skip[:, None].view(np.float32),
            b.node_first[:, None].view(np.float32)], axis=1)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        fields = {}
        if len(b.leaf_prims):
            wb, wl, wdepth = bvh_mod.collapse8(b)
            if trace_cuda.stack_depth(wdepth) is not None:
                n_leaves = len(b.leaf_prims) // bvh_mod.LEAF_SIZE
                lp = np.zeros((n_leaves, bvh_mod.LEAF_SIZE, 16), np.float32)
                lp[:, :, 0:9] = leaf_data.reshape(
                    n_leaves, bvh_mod.LEAF_SIZE, 9)
                lp[:, :, 9] = b.leaf_prims.reshape(
                    n_leaves, bvh_mod.LEAF_SIZE).astype(np.float32)
                fields.update(wbounds=dev(wb),
                              wlinks=dev(wl.astype(np.int32)),
                              leaf_packed=dev(lp))
        return cls(nodes=dev(packed),
                   leaf_prims=dev(b.leaf_prims.astype(np.int64)),
                   leaf_data=dev(leaf_data.astype(np.float32)),
                   leaf_shade=dev(leaf_shade.astype(np.float32)),
                   leaf_data_t1=(dev(leaf_data_t1.astype(np.float32))
                                 if leaf_data_t1 is not None else None),
                   **fields)


@dataclasses.dataclass
class DeviceGeometry:
    """Scene geometry as device tensors (SoA); triangles store (v0, e1, e2)
    for Moeller-Trumbore."""
    tri_v0: torch.Tensor      # [T, 3]
    tri_e1: torch.Tensor      # [T, 3]
    tri_e2: torch.Tensor      # [T, 3]
    tri_vn: torch.Tensor      # [T, 3, 3]
    tri_uv: torch.Tensor      # [T, 3, 2]
    tri_shader: torch.Tensor  # [T] int64 material id
    tri_quad_half: torch.Tensor  # [T] int64 (0 tri, 1/2 quad halves)
    tri_bvh: DeviceBVH
    tri_prim_slot: torch.Tensor | None = None
    has_motion: bool = False

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]


def make_device_geometry(tri_v=None, tri_vn=None, tri_uv=None,
                         tri_quad_half=None, tri_shader=None,
                         sph_c=None, sph_r=None, sph_shader=None,
                         line_vtx=None, line_radii=None, line_shader=None,
                         tri_v_t1=None, sph_c_t1=None, *,
                         device) -> DeviceGeometry:
    """Build the BVH + packed leaf data of a triangle soup (numpy in,
    tensors on ``device`` out).  tri_v: [T, 3, 3] vertices; tri_vn
    [T, 3, 3]; tri_uv [T, 3, 2].  Spheres and lines are refused: the
    reference covers the benchmark's triangle scenes."""
    for name, a in (('spheres', sph_r), ('lines', line_radii)):
        if a is not None and len(a):
            raise ValueError(f'the plain reference covers triangle scenes; '
                             f'this one has {len(a)} {name}')
    f32 = np.float32
    tri_v = np.zeros((0, 3, 3), f32) if tri_v is None else np.asarray(tri_v, f32)
    T = len(tri_v)
    tri_vn = np.zeros((T, 3, 3), f32) if tri_vn is None else np.asarray(tri_vn, f32)
    tri_uv = np.zeros((T, 3, 2), f32) if tri_uv is None else np.asarray(tri_uv, f32)
    tri_quad_half = (np.zeros((T,), np.int32) if tri_quad_half is None
                     else np.asarray(tri_quad_half, np.int32))
    tri_shader = (np.zeros((T,), np.int32) if tri_shader is None
                  else np.asarray(tri_shader, np.int32))

    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    if tri_v_t1 is not None:
        tri_v_t1 = np.asarray(tri_v_t1, f32)

    tb = bvh_mod.build_bvh(*bvh_mod.tri_bounds(tri_v, tri_v_t1)) if T else \
        bvh_mod.build_bvh(np.zeros((0, 3), f32), np.zeros((0, 3), f32))

    def pack(data, width):
        """Leaf-slot-major packed data: row i = data of leaf_prims[i]."""
        slots = np.maximum(tb.leaf_prims, 0)
        out = data[slots] if len(data) else np.zeros((len(slots), width), f32)
        return out.astype(f32)

    tri_data = (np.concatenate([tri_v[:, 0], e1, e2], axis=1) if T
                else np.zeros((0, 9), f32))
    tri_data_t1 = None
    if tri_v_t1 is not None and T:
        tri_data_t1 = np.concatenate([
            tri_v_t1[:, 0], tri_v_t1[:, 1] - tri_v_t1[:, 0],
            tri_v_t1[:, 2] - tri_v_t1[:, 0]], axis=1)
    tri_shade = (np.concatenate([
        tri_vn.reshape(T, 9), tri_uv.reshape(T, 6),
        tri_shader[:, None].astype(f32),
        tri_quad_half[:, None].astype(f32)], axis=1)
        if T else np.zeros((0, 17), f32))

    prim_slot = np.full(max(T, 1), -1, np.int64)
    lp = tb.leaf_prims
    prim_slot[lp[lp >= 0]] = np.nonzero(lp >= 0)[0]

    dev = lambda a, dt=None: torch.as_tensor(
        np.ascontiguousarray(a if dt is None else a.astype(dt)), device=device)
    return DeviceGeometry(
        tri_v0=dev(tri_v[:, 0]), tri_e1=dev(e1), tri_e2=dev(e2),
        tri_vn=dev(tri_vn), tri_uv=dev(tri_uv),
        tri_shader=dev(tri_shader, np.int64),
        tri_quad_half=dev(tri_quad_half, np.int64),
        tri_bvh=DeviceBVH.from_host(
            tb, pack(tri_data, 9), pack(tri_shade, 17),
            leaf_data_t1=(pack(tri_data_t1, 9)
                          if tri_data_t1 is not None else None),
            device=device),
        tri_prim_slot=dev(prim_slot),
        has_motion=tri_v_t1 is not None)


@dataclasses.dataclass
class Hit:
    """Wavefront hit record."""
    t: torch.Tensor     # [N] distance (MAX_DIST = miss)
    prim: torch.Tensor  # [N] int64 global prim id (-1 = miss)
    u: torch.Tensor     # [N] reference uv convention
    v: torch.Tensor     # [N]
    slot: torch.Tensor  # [N] int64 leaf-major slot (triangle hits; -1 else)

    @property
    def valid(self):
        return self.prim >= 0


def _segment_ends(t_max, n, dev) -> torch.Tensor:
    """t_max (a number or a tensor) as a detached contiguous [n] f32."""
    t = torch.as_tensor(t_max, device=dev).detach()
    return torch.broadcast_to(t, (n,)).to(torch.float32).contiguous()


def _kind(geom: DeviceGeometry, moving: bool) -> str:
    """'moving' where the rays' times lerp the triangles, else 'tri'."""
    return ('moving' if moving and geom.tri_bvh.leaf_data_t1 is not None
            else 'tri')


def _contiguous(x):
    return None if x is None else x.detach().contiguous()


def intersect(geom: DeviceGeometry, org, direction, ignore_prim=None,
              t_max=None, time=None) -> Hit:
    """Closest hit for a wavefront of rays.  org/dir: [N, 3].

    ``time`` [N] in [0, 1]: shutter-relative ray times on a moving scene
    (``geom.has_motion``): the leaf tests lerp triangle vertices per ray;
    ignored on a static scene.
    ``ignore_prim`` excludes one prim per ray (self-intersection).  The
    traversal is detached: gradients flow through the shading math around
    the hits, not through hit distances or ids."""
    org = org.detach().contiguous()
    direction = direction.detach().contiguous()
    n = org.shape[0]
    dev = org.device
    t_max = MAX_DIST if t_max is None else _segment_ends(t_max, n, dev)
    ig = _contiguous(ignore_prim)
    moving = geom.has_motion and time is not None
    tm = _contiguous(time) if moving else None

    hit = None
    if geom.n_tris:
        hit = trace_cuda.closest_hit(geom.tri_bvh, _kind(geom, moving), org,
                                     direction, t_max, ig, time=tm)
    if hit is None:
        t = torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=dev), (n,))
        none = torch.full((n,), INVALID_PRIM, dtype=torch.int64, device=dev)
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        hit = (t, none, zero, zero, none)
    return Hit(*hit)


def occluded(geom: DeviceGeometry, org, direction, t_max, ignore_prim=None,
             ignore_prim2=None, time=None) -> torch.Tensor:
    """Shadow-ray test: True where the segment [0, t_max) is blocked.
    Both endpoints' prims can be excluded; ``time`` as in ``intersect``;
    detached like it."""
    org = org.detach().contiguous()
    direction = direction.detach().contiguous()
    n = org.shape[0]
    t = _segment_ends(t_max, n, org.device)
    ig, ig2 = _contiguous(ignore_prim), _contiguous(ignore_prim2)
    moving = geom.has_motion and time is not None
    tm = _contiguous(time) if moving else None

    blocked = None
    if geom.n_tris:
        blocked = trace_cuda.any_hit(geom.tri_bvh, _kind(geom, moving), org,
                                     direction, t, ig, ig2, time=tm)
    if blocked is None:
        blocked = torch.zeros(n, dtype=torch.bool, device=org.device)
    return blocked
