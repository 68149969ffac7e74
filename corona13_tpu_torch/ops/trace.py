"""Wavefront ray intersection on the device (corona13_tpu/ops/trace.py).

Triangles go through the BVH8 traversal kernel (``trace_cuda``: CUDA on
the card, its plain torch version on the CPU).  Spheres and lines up to
``BRUTE_FORCE_MAX`` prims take the dense all-candidates test.  Global prim
ids: [0, T) triangles, [T, T+S) spheres, [T+S, T+S+L) lines.

Not ported yet (they raise NotImplementedError): the skip-link traversal
that serves sphere and line BVHs above ``BRUTE_FORCE_MAX`` prims and
trees too deep for the kernel's stack, lines in general, and the per-ray
time lerp of motion-blurred triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bvh as bvh_mod
from . import trace_cuda

INVALID_PRIM = -1
MAX_DIST = 3.4e38
BRUTE_FORCE_MAX = 64


@dataclasses.dataclass
class DeviceBVH:
    nodes: torch.Tensor       # [n_nodes, 8] f32: min3, max3, i32 skip, i32 first
    leaf_prims: torch.Tensor  # [slots] int64 prim ids, padded with -1
    leaf_data: torch.Tensor   # [slots, D] packed per-prim intersection data
    leaf_shade: torch.Tensor  # [slots, 17] vn(9), uv(6), shader, quad_half
    # wide (BVH8) layout for the traversal kernel (triangles only; None
    # when the tree is too deep for the kernel's stack)
    wbounds: torch.Tensor | None = None      # [Wn, 8, 8] f32
    wlinks: torch.Tensor | None = None       # [Wn*8] i32
    leaf_packed: torch.Tensor | None = None  # [n_leaves, 8, 16] f32
    leaf_data_t1: torch.Tensor | None = None  # [slots, D] shutter close

    @classmethod
    def from_host(cls, b: bvh_mod.FlatBVH, leaf_data: np.ndarray,
                  leaf_shade: np.ndarray | None = None,
                  leaf_data_t1: np.ndarray | None = None,
                  device='cpu') -> 'DeviceBVH':
        packed = np.concatenate([
            b.node_min, b.node_max,
            b.node_skip[:, None].view(np.float32),
            b.node_first[:, None].view(np.float32)], axis=1)
        if leaf_shade is None:
            leaf_shade = np.zeros((len(b.leaf_prims), 17), np.float32)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        wbounds = wlinks = leaf_packed = None
        if leaf_data.shape[-1] == 9 and len(b.leaf_prims):
            wb, wl, wdepth = bvh_mod.collapse8(b)
            n_leaves = len(b.leaf_prims) // bvh_mod.LEAF_SIZE
            lp = np.zeros((n_leaves, bvh_mod.LEAF_SIZE, 16), np.float32)
            lp[:, :, 0:9] = leaf_data.reshape(n_leaves, bvh_mod.LEAF_SIZE, 9)
            lp[:, :, 9] = b.leaf_prims.reshape(
                n_leaves, bvh_mod.LEAF_SIZE).astype(np.float32)
            # stack guard: each inner pop nets at most +7 entries, so the
            # worst case is wdepth*7 + 8; a deeper tree gets no wide layout
            # and intersect/occluded refuse it
            if wdepth * 7 + 8 <= trace_cuda.MAX_STACK:
                wbounds = dev(wb)
                wlinks = dev(wl.astype(np.int32))
                leaf_packed = dev(lp)
        return cls(nodes=dev(packed),
                   leaf_prims=dev(b.leaf_prims.astype(np.int64)),
                   leaf_data=dev(leaf_data.astype(np.float32)),
                   leaf_shade=dev(leaf_shade.astype(np.float32)),
                   wbounds=wbounds, wlinks=wlinks, leaf_packed=leaf_packed,
                   leaf_data_t1=(dev(leaf_data_t1.astype(np.float32))
                                 if leaf_data_t1 is not None else None))

    @property
    def n_nodes(self):
        return self.nodes.shape[0]


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
                         tri_v_t1=None, sph_c_t1=None,
                         device='cpu') -> DeviceGeometry:
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


def ray_tri_intersect_packed(rows, org, direction):
    """Moeller-Trumbore over packed candidate rows [N, K, 9] = (v0, e1, e2).
    Returns (t, u, v, hit_mask) each [N, K]; u weights vertex 2, v vertex 1."""
    from ..utils.math import cross
    v0 = rows[..., 0:3]
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    d = direction[..., None, :]
    o = org[..., None, :]
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(torch.abs(det) < 1e-20, 0.0, 1.0 / det)
    tvec = o - v0
    bv = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    bu = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    ok = (bv >= 0.0) & (bv <= 1.0) & (bu >= 0.0) & (bu + bv <= 1.0) & (t > 0.0)
    return t, bu, bv, ok


def ray_sphere_intersect(c, r, org, direction):
    """[N, K] candidates; returns the nearest positive root and its mask."""
    o = org[..., None, :] - c
    b = torch.sum(o * direction[..., None, :], dim=-1)
    cc = torch.sum(o * o, dim=-1) - r * r
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    ok = (disc > 0.0) & (t > 0.0)
    return t, ok


def _closest_select(tt, ok, t, prim, u, v, cand):
    """Reduce [N, K] candidate hits into the per-lane best (u, v and slot
    of the previous winner stay, as in the JAX package)."""
    tt = torch.where(ok, tt, MAX_DIST)
    best = torch.argmin(tt, dim=-1, keepdim=True)
    tbest = torch.gather(tt, -1, best)[..., 0]
    win = tbest < t
    return (torch.where(win, tbest, t),
            torch.where(win, torch.gather(cand, -1, best)[..., 0], prim),
            u, v)


def _checked_tri_bvh(geom: DeviceGeometry, time):
    if geom.n_lines:
        raise NotImplementedError('line prims are not ported yet')
    if geom.has_motion and time is not None:
        raise NotImplementedError('motion-blurred leaf tests are not ported yet')
    if geom.n_spheres > BRUTE_FORCE_MAX:
        raise NotImplementedError(
            f'sphere BVH traversal (> {BRUTE_FORCE_MAX} spheres) is not '
            'ported yet')
    b = geom.tri_bvh
    if geom.n_tris and b.wbounds is None:
        raise NotImplementedError(
            'triangle BVH too deep for the kernel stack; the skip-link '
            'traversal is not ported yet')
    return b


def intersect(geom: DeviceGeometry, org, direction, ignore_prim=None,
              t_max=None, time=None) -> Hit:
    """Closest hit for a wavefront of rays.  org/dir: [N, 3].

    ``ignore_prim`` excludes one prim per ray (self-intersection).  The
    traversal is detached: gradients flow through the shading math around
    the hits, not through hit distances or ids."""
    b = _checked_tri_bvh(geom, time)
    org = org.detach()
    direction = direction.detach()
    n = org.shape[0]
    dev = org.device
    if t_max is None:
        t = torch.full((n,), MAX_DIST, dtype=torch.float32, device=dev)
    else:
        t = torch.broadcast_to(torch.as_tensor(t_max, device=dev).detach(),
                               (n,)).to(torch.float32)
    prim = torch.full((n,), INVALID_PRIM, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    hslot = prim
    ig = ignore_prim if ignore_prim is not None else prim

    if geom.n_tris:
        t, p32, u, v, s32 = trace_cuda.traverse_tris(
            b.wbounds, b.wlinks, b.leaf_packed, org.contiguous(),
            direction.contiguous(), t.contiguous(),
            ig.to(torch.int32).contiguous())
        prim = p32.to(torch.int64)
        hslot = s32.to(torch.int64)

    if geom.n_spheres:
        gid = torch.arange(geom.n_spheres, device=dev) + geom.n_tris
        tt, ok = ray_sphere_intersect(geom.sph_c[None], geom.sph_r[None],
                                      org, direction)
        ok = ok & (tt <= t[..., None]) & (gid[None] != ig[..., None])
        t, prim, u, v = _closest_select(tt, ok, t, prim, u, v,
                                        gid.expand(tt.shape))
    return Hit(t=t, prim=prim, u=u, v=v, slot=hslot)


def occluded(geom: DeviceGeometry, org, direction, t_max, ignore_prim=None,
             ignore_prim2=None, time=None) -> torch.Tensor:
    """Shadow-ray test: True where the segment [0, t_max) is blocked.
    Both endpoints' prims can be excluded; detached like intersect."""
    b = _checked_tri_bvh(geom, time)
    org = org.detach()
    direction = direction.detach()
    n = org.shape[0]
    dev = org.device
    t = torch.broadcast_to(torch.as_tensor(t_max, device=dev).detach(),
                           (n,)).to(torch.float32)
    none = torch.full((n,), INVALID_PRIM, dtype=torch.int64, device=dev)
    ig = ignore_prim if ignore_prim is not None else none
    ig2 = ignore_prim2 if ignore_prim2 is not None else none
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)

    if geom.n_tris:
        _, p32, _, _, _ = trace_cuda.traverse_tris(
            b.wbounds, b.wlinks, b.leaf_packed, org.contiguous(),
            direction.contiguous(), t.contiguous(),
            ig.to(torch.int32).contiguous(),
            ig2.to(torch.int32).contiguous(), any_hit=True)
        blocked = p32 >= 0

    if geom.n_spheres:
        gid = torch.arange(geom.n_spheres, device=dev) + geom.n_tris
        tt, ok = ray_sphere_intersect(geom.sph_c[None], geom.sph_r[None],
                                      org, direction)
        ok = ok & (tt < t[..., None]) & (gid[None] != ig[..., None]) & \
            (gid[None] != ig2[..., None])
        blocked = blocked | ok.any(dim=-1)
    return blocked
