"""Wavefront ray intersection on the device (corona13_tpu/ops/trace.py).

Every prim kind goes through ``trace_cuda``: CUDA kernels on the card,
their plain torch versions (``trace_plain``) on the CPU.  Static triangles
take the BVH8 traversal kernel that replaces the TPU's; what the JAX
package serves with XLA's lockstep ``_traverse`` takes further forms of
the same kernel: triangles lerped at the ray ``time`` on a moving scene,
sphere and line BVHs above ``BRUTE_FORCE_MAX`` prims, the dense
all-candidates test of a shorter sphere or line list, and the skip-link
walk of a tree too deep for the kernel's stack.  One ``intersect`` or
``occluded`` call launches at most one kernel per non-empty prim kind,
triangles, then spheres, then lines, each starting from the best hit so
far, and no torch pass between them.  Global prim ids: [0, T) triangles,
[T, T+S) spheres, [T+S, T+S+L) lines.

As in the JAX package, sphere centres are lerped in time only in the dense
list (more than ``BRUTE_FORCE_MAX`` spheres are static in the leaf test),
and the dense list consults no bounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bvh as bvh_mod
from . import trace_cuda
from .trace_plain import (_closest_select, ray_cone_intersect,  # noqa: F401
                          ray_sphere_intersect, ray_tri_intersect,
                          ray_tri_intersect_packed)

INVALID_PRIM = -1
MAX_DIST = 3.4e38
BRUTE_FORCE_MAX = trace_cuda.DENSE_MAX   # longest list the dense form takes
_KIND_OF_WIDTH = {9: 'tri', 4: 'sphere', 8: 'line'}


@dataclasses.dataclass
class DeviceBVH:
    nodes: torch.Tensor       # [n_nodes, 8] f32: min3, max3, i32 skip, i32 first
    leaf_prims: torch.Tensor  # [slots] int64 prim ids, padded with -1
    leaf_data: torch.Tensor   # [slots, D] packed per-prim intersection data
    leaf_shade: torch.Tensor  # [slots, 17] vn(9), uv(6), shader, quad_half
    # wide (BVH8) layout for the traversal kernel (None when the tree is
    # empty or too deep for the kernel's stack); leaf_packed: triangles only
    wbounds: torch.Tensor | None = None      # [Wn, 8, 8] f32
    wlinks: torch.Tensor | None = None       # [Wn*8] i32
    leaf_packed: torch.Tensor | None = None  # [n_leaves, 8, 16] f32
    leaf_data_t1: torch.Tensor | None = None  # [slots, D] shutter close
    # the CUDA kernel's own records (trace_cuda.pack_nodes, pack_leaf_rows,
    # pack_line_rows, pack_moving_rows, pack_nodes_preorder) and the stack
    # entries a thread needs; kleaves also serve the deep-tree walk, which
    # reads ``nodes``, and for lines the plain walk, which reads each
    # prim's terms there
    knodes: torch.Tensor | None = None       # [Wn, 8, 8] f32, link in [.., 7]
    knodes_pre: torch.Tensor | None = None   # moving, sphere: preorder
    kleaves: torch.Tensor | None = None      # [n_leaves, 8, ROW] f32
    kleaves_t1: torch.Tensor | None = None   # [M, 12] the moving rows' close
    stack_depth: int = 0
    # a tree without a wide layout: the deep walk's records
    # (trace_cuda.pack_bin_nodes) and the stack entries a thread needs
    # (its binary levels); None where that exceeds MAX_BIN_STACK, and the
    # tree is walked by its skip links
    bnodes: torch.Tensor | None = None       # [1 + inner nodes, 16] f32
    bin_depth: int = 0

    @classmethod
    def from_host(cls, b: bvh_mod.FlatBVH, leaf_data: np.ndarray,
                  leaf_shade: np.ndarray | None = None,
                  leaf_data_t1: np.ndarray | None = None, *,
                  device) -> 'DeviceBVH':
        packed = np.concatenate([
            b.node_min, b.node_max,
            b.node_skip[:, None].view(np.float32),
            b.node_first[:, None].view(np.float32)], axis=1)
        if leaf_shade is None:
            leaf_shade = np.zeros((len(b.leaf_prims), 17), np.float32)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        kind = _KIND_OF_WIDTH[leaf_data.shape[-1]]
        fields = {}
        if len(b.leaf_prims) and (kind == 'tri' or b.n_prims):
            if leaf_data_t1 is not None:
                kl, kl1 = trace_cuda.pack_moving_rows(leaf_data, leaf_data_t1,
                                                      b.leaf_prims)
                fields.update(kleaves=dev(kl), kleaves_t1=dev(kl1))
            elif kind == 'line':
                fields['kleaves'] = trace_cuda.pack_line_rows(
                    dev(leaf_data), dev(b.leaf_prims))
            else:
                fields['kleaves'] = dev(trace_cuda.pack_leaf_rows(
                    kind, leaf_data, b.leaf_prims))
            wb, wl, wdepth = bvh_mod.collapse8(b)
            # stack guard: each inner pop nets at most +7, so the worst
            # case is wdepth*7 + 8; a deeper tree gets no wide layout and
            # is walked by the deep walk (or, deeper still, skip links)
            if trace_cuda.stack_depth(wdepth) is None:
                fields.update(_deep_fields(packed, b.leaf_prims, dev))
            else:
                # a sphere leaf's link carries its filled rows
                filled = trace_cuda.leaf_fill(b.leaf_prims) \
                    if kind == 'sphere' else None
                fields.update(
                    wbounds=dev(wb), wlinks=dev(wl.astype(np.int32)),
                    knodes=dev(trace_cuda.pack_nodes(wb, wl, filled)),
                    stack_depth=trace_cuda.stack_depth(wdepth))
                if leaf_data_t1 is not None or kind == 'sphere':
                    fields['knodes_pre'] = dev(
                        trace_cuda.pack_nodes_preorder(wb, wl, filled))
                if kind == 'tri':
                    n_leaves = len(b.leaf_prims) // bvh_mod.LEAF_SIZE
                    lp = np.zeros((n_leaves, bvh_mod.LEAF_SIZE, 16),
                                  np.float32)
                    lp[:, :, 0:9] = leaf_data.reshape(
                        n_leaves, bvh_mod.LEAF_SIZE, 9)
                    lp[:, :, 9] = b.leaf_prims.reshape(
                        n_leaves, bvh_mod.LEAF_SIZE).astype(np.float32)
                    fields['leaf_packed'] = dev(lp)
        return cls(nodes=dev(packed),
                   leaf_prims=dev(b.leaf_prims.astype(np.int64)),
                   leaf_data=dev(leaf_data.astype(np.float32)),
                   leaf_shade=dev(leaf_shade.astype(np.float32)),
                   leaf_data_t1=(dev(leaf_data_t1.astype(np.float32))
                                 if leaf_data_t1 is not None else None),
                   **fields)

    @property
    def n_nodes(self):
        return self.nodes.shape[0]


def _deep_fields(nodes: np.ndarray, leaf_prims: np.ndarray, dev) -> dict:
    """The deep walk's fields of a tree without a wide layout: its
    records and stack entries (one a binary level), or none (skip links)
    where the levels exceed ``trace_cuda.MAX_BIN_STACK``."""
    depth = trace_cuda.bin_depth(nodes)
    if depth > trace_cuda.MAX_BIN_STACK:
        return {}
    return dict(bnodes=dev(trace_cuda.pack_bin_nodes(nodes, leaf_prims)),
                bin_depth=depth)


def without_wide(bvh: DeviceBVH) -> DeviceBVH:
    """``bvh`` as upload lays out a tree too deep for the wide stack: no
    wide layout, the deep walk's records (or, above
    ``trace_cuda.MAX_BIN_STACK`` levels, none: skip links).  Its leaf
    records stay."""
    dev = bvh.nodes.device
    fields = dict(wbounds=None, wlinks=None, leaf_packed=None, knodes=None,
                  knodes_pre=None, stack_depth=0, bnodes=None, bin_depth=0)
    fields.update(_deep_fields(bvh.nodes.cpu().numpy(),
                               bvh.leaf_prims.cpu().numpy(),
                               lambda a: torch.as_tensor(a, device=dev)))
    return dataclasses.replace(bvh, **fields)


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
    sph_c: torch.Tensor       # [S, 3]
    sph_r: torch.Tensor       # [S]
    sph_shader: torch.Tensor  # [S]
    line_v0: torch.Tensor     # [L, 3]
    line_v1: torch.Tensor     # [L, 3]
    line_r0: torch.Tensor     # [L]
    line_r1: torch.Tensor     # [L]
    line_shader: torch.Tensor  # [L]
    tri_bvh: DeviceBVH
    sph_bvh: DeviceBVH
    line_bvh: DeviceBVH
    tri_prim_slot: torch.Tensor | None = None
    sph_c_t1: torch.Tensor | None = None
    has_motion: bool = False
    # a line list short enough for the dense form: its records with each
    # line's terms (trace_cuda.pack_dense_lines), made where the lines are
    line_dense: torch.Tensor | None = None   # [L, 12] f32

    def __post_init__(self):
        if self.line_dense is None and 0 < self.n_lines <= BRUTE_FORCE_MAX:
            self.line_dense = trace_cuda.pack_dense_lines(
                self.line_v0, self.line_v1, self.line_r0, self.line_r1)

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_c.shape[0]

    @property
    def n_lines(self):
        return self.line_v0.shape[0]


def make_device_geometry(tri_v=None, tri_vn=None, tri_uv=None,
                         tri_quad_half=None, tri_shader=None,
                         sph_c=None, sph_r=None, sph_shader=None,
                         line_vtx=None, line_radii=None, line_shader=None,
                         tri_v_t1=None, sph_c_t1=None, *,
                         device) -> DeviceGeometry:
    """Build BVHs + packed leaf data from host triangle/sphere/line soup
    (numpy in, tensors on ``device`` out).

    tri_v: [T, 3, 3] vertices; tri_vn [T, 3, 3]; tri_uv [T, 3, 2];
    line_vtx [L, 2, 3]; line_radii [L, 2].
    """
    f32 = np.float32
    tri_v = np.zeros((0, 3, 3), f32) if tri_v is None else np.asarray(tri_v, f32)
    T = len(tri_v)
    tri_vn = np.zeros((T, 3, 3), f32) if tri_vn is None else np.asarray(tri_vn, f32)
    tri_uv = np.zeros((T, 3, 2), f32) if tri_uv is None else np.asarray(tri_uv, f32)
    tri_quad_half = (np.zeros((T,), np.int32) if tri_quad_half is None
                     else np.asarray(tri_quad_half, np.int32))
    tri_shader = (np.zeros((T,), np.int32) if tri_shader is None
                  else np.asarray(tri_shader, np.int32))
    sph_c = np.zeros((0, 3), f32) if sph_c is None else np.asarray(sph_c, f32)
    sph_r = np.zeros((0,), f32) if sph_r is None else np.asarray(sph_r, f32)
    S = len(sph_r)
    sph_shader = (np.zeros((S,), np.int32) if sph_shader is None
                  else np.asarray(sph_shader, np.int32))
    line_vtx = (np.zeros((0, 2, 3), f32) if line_vtx is None
                else np.asarray(line_vtx, f32))
    line_radii = (np.zeros((0, 2), f32) if line_radii is None
                  else np.asarray(line_radii, f32))
    L = len(line_radii)
    line_shader = (np.zeros((L,), np.int32) if line_shader is None
                   else np.asarray(line_shader, np.int32))

    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    has_motion = tri_v_t1 is not None or sph_c_t1 is not None
    if tri_v_t1 is not None:
        tri_v_t1 = np.asarray(tri_v_t1, f32)
    if sph_c_t1 is not None:
        sph_c_t1 = np.asarray(sph_c_t1, f32)

    tb = bvh_mod.build_bvh(*bvh_mod.tri_bounds(tri_v, tri_v_t1)) if T else \
        bvh_mod.build_bvh(np.zeros((0, 3), f32), np.zeros((0, 3), f32))
    sb = bvh_mod.build_bvh(*bvh_mod.sphere_bounds(sph_c, sph_r, sph_c_t1))
    lb = bvh_mod.build_bvh(*bvh_mod.line_bounds(line_vtx, line_radii))

    def pack(bvh, data, width):
        """Leaf-slot-major packed data: row i = data of leaf_prims[i]."""
        slots = np.maximum(bvh.leaf_prims, 0)
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
    sph_data = (np.concatenate([sph_c, sph_r[:, None]], axis=1) if S
                else np.zeros((0, 4), f32))
    line_data = (np.concatenate([line_vtx[:, 0], line_vtx[:, 1], line_radii],
                                axis=1) if L else np.zeros((0, 8), f32))

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
        sph_c=dev(sph_c), sph_r=dev(sph_r),
        sph_shader=dev(sph_shader, np.int64),
        line_v0=dev(line_vtx[:, 0]), line_v1=dev(line_vtx[:, 1]),
        line_r0=dev(line_radii[:, 0]), line_r1=dev(line_radii[:, 1]),
        line_shader=dev(line_shader, np.int64),
        tri_bvh=DeviceBVH.from_host(
            tb, pack(tb, tri_data, 9), pack(tb, tri_shade, 17),
            leaf_data_t1=(pack(tb, tri_data_t1, 9)
                          if tri_data_t1 is not None else None),
            device=device),
        sph_bvh=DeviceBVH.from_host(sb, pack(sb, sph_data, 4), device=device),
        line_bvh=DeviceBVH.from_host(lb, pack(lb, line_data, 8),
                                     device=device),
        tri_prim_slot=dev(prim_slot),
        sph_c_t1=dev(sph_c_t1) if sph_c_t1 is not None else None,
        has_motion=has_motion)


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


def _kinds(geom: DeviceGeometry, moving: bool):
    """The non-empty prim kinds of a call in the order they are traced:
    (target, kind, prim_offset) as ``trace_cuda.closest_hit`` takes them;
    a short sphere or line list is its own dense target."""
    out = []
    if geom.n_tris:
        lerped = moving and geom.tri_bvh.leaf_data_t1 is not None
        out.append((geom.tri_bvh, 'moving' if lerped else 'tri', 0))
    if geom.n_spheres:
        dense = (geom.sph_c, geom.sph_r, geom.sph_c_t1 if moving else None)
        out.append((dense if geom.n_spheres <= BRUTE_FORCE_MAX
                    else geom.sph_bvh, 'sphere', geom.n_tris))
    if geom.n_lines:
        dense = (geom.line_dense,)
        out.append((dense if geom.n_lines <= BRUTE_FORCE_MAX
                    else geom.line_bvh, 'line', geom.n_tris + geom.n_spheres))
    return out


def _contiguous(x):
    return None if x is None else x.detach().contiguous()


def intersect(geom: DeviceGeometry, org, direction, ignore_prim=None,
              t_max=None, time=None) -> Hit:
    """Closest hit for a wavefront of rays.  org/dir: [N, 3].

    ``time`` [N] in [0, 1]: shutter-relative ray times on a moving scene
    (``geom.has_motion``): the leaf tests lerp triangle vertices and the
    dense list sphere centres per ray; ignored on a static scene.
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
    for target, kind, offset in _kinds(geom, moving):
        # the first launch allocates and writes all five outputs, the
        # later ones update them
        hit = trace_cuda.closest_hit(target, kind, org, direction, t_max, ig,
                                     time=tm, prim_offset=offset, carry=hit)
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
    detached like it.  A lane that one prim kind blocks does no work in
    the next."""
    org = org.detach().contiguous()
    direction = direction.detach().contiguous()
    n = org.shape[0]
    t = _segment_ends(t_max, n, org.device)
    ig, ig2 = _contiguous(ignore_prim), _contiguous(ignore_prim2)
    moving = geom.has_motion and time is not None
    tm = _contiguous(time) if moving else None

    blocked = None
    for target, kind, offset in _kinds(geom, moving):
        blocked = trace_cuda.any_hit(target, kind, org, direction, t, ig, ig2,
                                     time=tm, prim_offset=offset,
                                     carry=blocked)
    if blocked is None:
        blocked = torch.zeros(n, dtype=torch.bool, device=org.device)
    return blocked
