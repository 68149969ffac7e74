# Frozen copy of corona13_tpu_torch/ops/trace_cuda.py (lines 1-1302) as of commit 2084081, for the benchmark's plain reference.
# Kept: what the benchmark's cells call (static and moving triangle trees); dropped: the CUDA build and launch code, the kernel's record packing and argument checks, the deep, dense, sphere, line and counting walks.
"""BVH traversal of triangle trees by the plain versions: the wide-tree
walk of static triangles with the TPU kernel's winner
(``traverse_tris_plain``) and the skip-link walk
(``trace_plain.walk_plain``) of moving triangles and of a tree too deep
for the wide stack, behind ``closest_hit`` / ``any_hit`` as the port
calls them."""

from __future__ import annotations

import torch

from . import trace_plain
from .bvh import LEAF_SIZE as LEAF
from .trace_plain import inv_dir

MAX_STACK = 192  # stack entries a thread can have: 96 KB of shared memory
K_MASK = 7       # low mantissa bits that carry the winning leaf row
NO_HIT = 0x7f000000


def stack_depth(wdepth: int) -> int | None:
    """Stack entries a thread needs for a wide tree of depth ``wdepth``:
    each inner pop nets at most +7, so wdepth*7 + 8.  None above
    ``MAX_STACK``: such a tree gets no wide layout."""
    need = int(wdepth) * 7 + 8
    return need if need <= MAX_STACK else None


def _fresh_hit(n, t_init, dev):
    """The hit record no launch has touched: (t_init, -1, 0, 0, -1)."""
    if isinstance(t_init, torch.Tensor):
        t = t_init.clone()
    else:
        t = torch.full((n,), float(t_init), dtype=torch.float32, device=dev)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    return t, none, zero, zero.clone(), none.clone()


def _wide_tris_plain(bvh, org, direction, t_init, ignore_prim, ignore_prim2,
                     any_hit):
    """The static triangles of a wide tree by ``traverse_tris_plain`` (the
    TPU kernel's winner)."""
    out = traverse_tris_plain(bvh.wbounds, bvh.wlinks, bvh.leaf_packed, org,
                              direction, t_init, ignore_prim, ignore_prim2,
                              any_hit=any_hit)
    return out[1] >= 0 if any_hit else out


def _trace(bvh, kind, org, direction, t_init, ignore_prim, ignore_prim2,
           time, any_hit):
    """closest_hit and any_hit: a tree of static triangles with a wide
    layout by the wide walk, else by its skip links."""
    if kind == 'moving' and time is None:
        raise ValueError('traverse_tris: moving triangles need ray times')
    if kind == 'tri' and bvh.wbounds is not None:
        return _wide_tris_plain(bvh, org, direction, t_init, ignore_prim,
                                ignore_prim2, any_hit)
    # the plain versions flag a blocked lane as prim >= 0
    out = trace_plain.walk_plain(
        bvh, kind, org, direction, *_fresh_hit(org.shape[0], t_init,
                                               org.device),
        ignore_prim=ignore_prim, ignore_prim2=ignore_prim2, time=time,
        any_hit=any_hit)
    return out[1] >= 0 if any_hit else out[:5]


def closest_hit(bvh, kind, org, direction, t_init, ignore_prim=None,
                time=None):
    """Closest hit of the triangles of ``bvh`` (a ``trace.DeviceBVH``):
    (t, prim, u, v, slot) [N].  kind: 'tri', or 'moving' (triangles
    lerped at the ray ``time`` [N]).  The static triangles of a wide tree
    are the TPU kernel's closest-hit specialisation."""
    return _trace(bvh, kind, org, direction, t_init, ignore_prim, None,
                  time, any_hit=False)


def any_hit(bvh, kind, org, direction, t_init, ignore_prim=None,
            ignore_prim2=None, time=None):
    """blocked [N] bool: a triangle of ``bvh`` lies in (0, t_init).
    Arguments as ``closest_hit``."""
    return _trace(bvh, kind, org, direction, t_init, ignore_prim,
                  ignore_prim2, time, any_hit=True)


def _slab_hits(blk, o, iv, t):
    """The TPU kernel's slab test (trace_pallas.py:94-108) of the 8
    children of wide nodes ``blk`` [..., 8, 8] against rays (origins
    ``o`` and clamped inverse directions ``iv`` [..., 1, 3], running t
    [..., 1]): [..., 8] true where the segment (0, t) meets a child's box
    and the child is not empty (push weight 0)."""
    t0 = (blk[..., 0:3] - o) * iv
    t1 = (blk[..., 3:6] - o) * iv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                       torch.clamp(lo[..., 2], min=0.0))
    tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                       torch.minimum(hi[..., 2], t))
    return (tn <= tf) & (tf > 0.0) & (blk[..., 6] != 0.0)


def _push(stack, sp, rows, nodes, hitc, links, weight):
    """Push the hit children ``hitc`` [k, 8] of wide nodes ``nodes`` [k]
    onto the stacks ``rows`` [k] in ascending child index, a leaf child
    (push weight >= 256) as -link - 1."""
    lk = links[nodes]
    val = torch.where(weight[nodes] >= 256.0, -lk - 1, lk)
    hi_i = hitc.to(torch.int64)
    pos = sp[rows][:, None] + torch.cumsum(hi_i, dim=1) - hi_i
    at = rows[:, None].expand(-1, 8)
    stack[at[hitc], pos[hitc]] = val[hitc]
    sp[rows] += hi_i.sum(dim=1)


def _tri_rows(r, o, d, t, ig1, ig2):
    """The TPU kernel's Moeller-Trumbore test (trace_pallas.py:129-152) of
    leaf rows ``r`` [..., 8, 16] against rays (``o``, ``d`` [..., 1, 3],
    running t and ignore ids [..., 1]): (ok, t, u, v, prim) [..., 8]."""
    v0x, v0y, v0z = r[..., 0], r[..., 1], r[..., 2]
    e1x, e1y, e1z = r[..., 3], r[..., 4], r[..., 5]
    e2x, e2y, e2z = r[..., 6], r[..., 7], r[..., 8]
    cand = r[..., 9].to(torch.int32)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) < 1e-20, 0.0, 1.0 / det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    bv = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    bu = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((bv >= 0.0) & (bv <= 1.0) & (bu >= 0.0) & (bu + bv <= 1.0)
          & (tt > 0.0) & (tt < t) & (cand >= 0) & (cand != ig1)
          & (cand != ig2))
    return ok, tt, bu, bv, cand.expand_as(tt)


def _winner(ok, tt):
    """The TPU kernel's winner of a leaf (trace_pallas.py:160-173): the
    minimum of (bits(t) & ~7) | row over the rows ``ok`` [..., 8]; returns
    (won [...], row [...] int64)."""
    rows = torch.arange(LEAF, dtype=torch.int32, device=tt.device)
    enc = torch.where(ok, (tt.view(torch.int32) & ~K_MASK) | rows, NO_HIT)
    best = enc.amin(dim=-1)
    return best < NO_HIT, (best & K_MASK).to(torch.int64)


def _start(org, direction, t_init, ignore_prim, ignore_prim2):
    """A wavefront as the walks take it: (inverse directions, running t,
    both ignore ids as int64 [N])."""
    n, dev = org.shape[0], org.device
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ig1 = none if ignore_prim is None else ignore_prim.to(torch.int64)
    ig2 = none if ignore_prim2 is None else ignore_prim2.to(torch.int64)
    if isinstance(t_init, torch.Tensor):
        t = t_init.clone()
    else:
        t = torch.full((n,), float(t_init), dtype=torch.float32, device=dev)
    return inv_dir(direction), t, ig1, ig2


def traverse_tris_plain(wbounds, wlinks, leaf_packed, org, direction,
                        t_init, ignore_prim=None, ignore_prim2=None,
                        any_hit=False):
    """The kernel's walk in vectorised torch: per-ray stacks
    [N, MAX_STACK] and a lockstep loop over the rays whose stack is not
    empty; each step pops one entry per ray.  It walks the reference arrays
    with the slab, Moeller-Trumbore and winner-encoding arithmetic of
    ``csrc/traverse_tris.cu`` and takes the argument forms of
    ``traverse_tris``."""
    n = org.shape[0]
    dev = org.device
    inv, t, ig1, ig2 = _start(org, direction, t_init, ignore_prim,
                              ignore_prim2)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev)
    sp = (t > 0).to(torch.int64)           # root (wide node 0) pushed
    links = wlinks.to(torch.int64).reshape(-1, 8)
    weight = wbounds[:, :, 6]
    act = torch.nonzero(sp > 0)[:, 0]
    while act.numel():
        top = sp[act] - 1
        e = stack[act, top]
        sp[act] = top
        inner = e >= 0

        ai, ei = act[inner], e[inner]
        if ai.numel():
            hitc = _slab_hits(wbounds[ei], org[ai][:, None, :],
                              inv[ai][:, None, :], t[ai][:, None])
            _push(stack, sp, ai, ei, hitc, links, weight)

        al, el = act[~inner], e[~inner]
        if al.numel():
            lid = -el - 1
            ok, tt, bu, bv, cand = _tri_rows(
                leaf_packed[lid], org[al][:, None, :],
                direction[al][:, None, :], t[al][:, None],
                ig1[al][:, None], ig2[al][:, None])
            if any_hit:
                b = al[ok.any(dim=1)]
                prim[b] = 0
                t[b] = -1.0
                sp[b] = 0
            else:
                win, k = _winner(ok, tt)
                wr = torch.nonzero(win)[:, 0]
                k = k[wr]
                dst = al[wr]
                t[dst] = tt[wr, k]
                u[dst] = bu[wr, k]
                v[dst] = bv[wr, k]
                prim[dst] = cand[wr, k].to(torch.int64)
                slot[dst] = lid[wr] * LEAF + k
        act = act[sp[act] > 0]
    return t, prim, u, v, slot

