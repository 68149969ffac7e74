"""Plain torch versions of the leaf tests and of the walks that serve them.

What XLA's lockstep ``_traverse`` and the dense small-list branches of
``corona13_tpu/ops/trace.py`` compute: the candidate intersectors
(triangle, sphere, truncated cone), the closest-hit reduction, a
skip-link walk over ``DeviceBVH.nodes`` with the four leaf tests (static
and time-lerped triangles, spheres, lines), and the all-candidates test of
a short prim list.  These are the CPU path of ``ops/trace_cuda.py``'s
wrappers and the plain versions its CUDA forms are held against; nothing
that runs on the card calls them.

The arithmetic is written component by component, in the order of
``csrc/traverse_tris.cu``: torch rounds every operation once, the kernel
file is built with ``-fmad=false``, so both give the same bits.
"""

from __future__ import annotations

import torch

from .bvh import LEAF_SIZE as LEAF

MAX_DIST = 3.4e38


def inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1/direction with components clamped away from 0 at +-1e-20."""
    return 1.0 / torch.where(torch.abs(direction) < 1e-20,
                             torch.where(direction < 0, -1e-20, 1e-20),
                             direction)


def _xyz(a):
    return a[..., 0], a[..., 1], a[..., 2]


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def ray_tri_intersect_packed(rows, org, direction):
    """Moeller-Trumbore over packed candidate rows [N, K, 9] = (v0, e1, e2).
    Returns (t, u, v, hit_mask) each [N, K]; u weights vertex 2, v vertex 1."""
    v0x, v0y, v0z = _xyz(rows[..., 0:3])
    e1x, e1y, e1z = _xyz(rows[..., 3:6])
    e2x, e2y, e2z = _xyz(rows[..., 6:9])
    ox, oy, oz = _xyz(org[..., None, :])
    dx, dy, dz = _xyz(direction[..., None, :])
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = _dot(e1x, e1y, e1z, px, py, pz)
    inv_det = torch.where(torch.abs(det) < 1e-20, 0.0, 1.0 / det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    bv = _dot(tx, ty, tz, px, py, pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    bu = _dot(dx, dy, dz, qx, qy, qz) * inv_det
    t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv_det
    ok = (bv >= 0.0) & (bv <= 1.0) & (bu >= 0.0) & (bu + bv <= 1.0) & (t > 0.0)
    return t, bu, bv, ok


def ray_tri_intersect(v0, e1, e2, org, direction):
    """ray_tri_intersect_packed over separate v0 / e1 / e2 candidate arrays
    [N, K, 3] (the JAX package's compatibility wrapper)."""
    return ray_tri_intersect_packed(torch.cat([v0, e1, e2], dim=-1), org,
                                    direction)


def ray_sphere_intersect(c, r, org, direction):
    """[N, K] candidates; returns the nearest positive root and its mask."""
    cx, cy, cz = _xyz(c)
    ox, oy, oz = _xyz(org[..., None, :])
    dx, dy, dz = _xyz(direction[..., None, :])
    ox, oy, oz = ox - cx, oy - cy, oz - cz
    b = _dot(ox, oy, oz, dx, dy, dz)
    cc = _dot(ox, oy, oz, ox, oy, oz) - r * r
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    ok = (disc > 0.0) & (t > 0.0)
    return t, ok


def line_terms(v0, v1, r0, r1):
    """A line prim's own terms of the cone test: (unit axis [..., 3],
    length, k, k*k) of the truncated cone through (v0, r0) -> (v1, r1),
    by the reference test's expressions.  The kernel's line records carry
    them (``trace_cuda.pack_line_rows``), computed once a prim."""
    ax, ay, az = _xyz(v1 - v0)
    length = torch.sqrt(torch.clamp(_dot(ax, ay, az, ax, ay, az), min=1e-20))
    axis = torch.stack([ax / length, ay / length, az / length], dim=-1)
    k = (r1 - r0) / length
    return axis, length, k, k * k


def _cone_disc(v0, axis, k, kk, r0, org, direction):
    """What the cone test computes up to its discriminant: (ya, wd, a, b,
    c, disc) of ``ray_cone_test``, in its order."""
    ax, ay, az = _xyz(axis)
    ox, oy, oz = _xyz(org[..., None, :] - v0)
    wx, wy, wz = _xyz(direction[..., None, :])
    ya = _dot(ox, oy, oz, ax, ay, az)
    wd = _dot(wx, wy, wz, ax, ay, az)
    ow = _dot(ox, oy, oz, wx, wy, wz)
    oo = _dot(ox, oy, oz, ox, oy, oz)
    s = r0 + k * ya
    a = 1.0 - wd * wd - kk * wd * wd
    b = 2.0 * (ow - ya * wd - k * wd * s)
    c = oo - ya * ya - s * s
    return ya, wd, a, b, c, b * b - 4.0 * a * c


def ray_cone_test(v0, axis, length, k, kk, r0, org, direction):
    """The cone test from a prim's own terms (``line_terms``): [N, K]
    candidates, the per-ray operations of ``ray_cone_intersect`` in its
    order.  Returns (t, y_frac, ok)."""
    return _cone_roots(*_cone_disc(v0, axis, k, kk, r0, org, direction),
                       length)


def _cone_roots(ya, wd, a, b, c, disc, length):
    """The cone test from its discriminant on (``_cone_disc``)."""
    # robust quadratic
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    asafe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    t0 = q / asafe
    tiny = torch.abs(q) < 1e-20
    t1 = torch.where(tiny, MAX_DIST, c / torch.where(tiny, 1.0, q))
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)

    def accept(t):
        y = ya + t * wd
        return (t > 0.0) & (y >= 0.0) & (y <= length)

    t = torch.where(accept(tlo), tlo, thi)
    ok = (disc > 0.0) & accept(t)
    y = torch.clamp((ya + t * wd) / length, 0.0, 1.0)
    return t, y, ok


def ray_cone_intersect(v0, v1, r0, r1, org, direction):
    """Truncated cone through the circles (v0, r0) -> (v1, r1): a line prim.

    All [N, K] candidates.  Returns (t, y_frac, ok) with y_frac in [0, 1]
    the axial coordinate (the hit's u along the fibre)."""
    return ray_cone_test(v0, *line_terms(v0, v1, r0, r1), r0, org, direction)


def lerp_rows(rows, rows1, w):
    """Shutter-open and shutter-close records at the ray time w, written
    as a*(1-w) + b*w (edges are linear in the vertices, so lerping packed
    (v0, e1, e2) rows is lerping the vertices)."""
    return rows * (1.0 - w) + rows1 * w


def _closest_select(tt, ok, t, prim, u, v, cand, uu=None, vv=None,
                    slot=None, cand_slot=None):
    """Reduce [N, K] candidate hits into the per-lane best: the smallest
    tt, the first candidate on an exact tie, accepted when strictly below
    the running t.  u, v and slot stay the previous winner's where the
    candidates carry none."""
    tt = torch.where(ok, tt, MAX_DIST)
    best = torch.argmin(tt, dim=-1, keepdim=True)
    sel = lambda a: torch.gather(a, -1, best)[..., 0]
    tbest = sel(tt)
    win = tbest < t
    out = (torch.where(win, tbest, t),
           torch.where(win, sel(cand), prim),
           torch.where(win, sel(uu), u) if uu is not None else u,
           torch.where(win, sel(vv), v) if vv is not None else v)
    if slot is None:
        return out
    return out + (torch.where(win, sel(cand_slot), slot),)


def _candidates(kind, rows, rows1, org, direction, time):
    """(tt, uu, vv, ok, disc) of one prim kind's test on candidate rows
    [N, K, D] ('tri' and 'moving': D = 9, 'sphere': 4; 'line': the kernel's
    records, D = 12, whose terms ``ray_cone_test`` reads); disc: the cone
    test's discriminant, None for the other kinds."""
    if kind == 'moving':
        rows = lerp_rows(rows, rows1, time[..., None, None])
    if kind in ('tri', 'moving'):
        return ray_tri_intersect_packed(rows, org, direction) + (None,)
    if kind == 'sphere':
        tt, ok = ray_sphere_intersect(rows[..., 0:3], rows[..., 3], org,
                                      direction)
        return tt, None, None, ok, None
    quad = _cone_disc(rows[..., 0:3], rows[..., 4:7], rows[..., 9],
                      rows[..., 10], rows[..., 7], org, direction)
    tt, y, ok = _cone_roots(*quad, rows[..., 8])
    return tt, y, None, ok, quad[5]


def _not_ignored(gid, ig1, ig2):
    ok = torch.ones_like(gid, dtype=torch.bool)
    for ig in (ig1, ig2):
        if ig is not None:
            ok = ok & (gid != ig[..., None])
    return ok


def walk_plain(bvh, kind, org, direction, t, prim, u, v, slot,
               ignore_prim=None, ignore_prim2=None, time=None, prim_offset=0,
               any_hit=False, want_counts=False):
    """Skip-link walk of one BVH for a wavefront, in lockstep over the rays
    that are still under way; each step visits one node per ray.

    ``bvh``: a ``trace.DeviceBVH`` (``nodes``, ``leaf_prims``,
    ``leaf_data`` and, for kind 'moving', ``leaf_data_t1``; for kind 'line'
    the kernel's records ``kleaves``, which carry each prim's own terms).
    t, prim, u, v, slot [N]: the running hit, which the walk starts from
    and returns updated (new tensors); lanes with t <= 0 do no work.
    any_hit: lanes
    with prim >= 0 are blocked already and do no work; a blocker sets
    prim = 0 and ends the lane.  Ids are global: a leaf's local id plus
    ``prim_offset`` is what the ignore ids exclude and what prim receives.
    want_counts appends the per-ray numbers of nodes visited, of leaves
    tested and (kind 'line') of filled rows tested whose discriminant is not
    positive, which the kernel's cone test leaves early."""
    n_nodes = bvh.nodes.shape[0]
    skip_of = bvh.nodes[:, 6].contiguous().view(torch.int32).to(torch.int64)
    first_of = bvh.nodes[:, 7].contiguous().view(torch.int32).to(torch.int64)
    inv = inv_dir(direction)
    t, prim, u, v, slot = (x.clone() for x in (t, prim, u, v, slot))
    dev = org.device
    node = torch.zeros(org.shape[0], dtype=torch.int64, device=dev)
    visits = torch.zeros_like(node)
    leafs = torch.zeros_like(node)
    missed = torch.zeros_like(node)
    ls = torch.arange(LEAF, device=dev)
    data = bvh.kleaves.reshape(-1, bvh.kleaves.shape[-1]) if kind == 'line' \
        else bvh.leaf_data
    live = t > 0
    if any_hit:
        live = live & (prim < 0)
    act = torch.nonzero(live)[:, 0]
    while act.numel():
        nd = node[act]
        row = bvh.nodes[nd]
        o, iv = org[act], inv[act]
        t0 = (row[:, 0:3] - o) * iv
        t1 = (row[:, 3:6] - o) * iv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = torch.clamp(torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                                       lo[:, 2]), min=0.0)
        tf = torch.minimum(torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                                         hi[:, 2]), t[act])
        box = tn <= tf
        first, skip = first_of[nd], skip_of[nd]
        visits[act] += 1
        at_leaf = box & (first >= 0)
        al = act[at_leaf]
        if al.numel():
            leafs[al] += 1
            cslot = first[at_leaf][:, None] + ls
            cand = bvh.leaf_prims[cslot]
            rows1 = bvh.leaf_data_t1[cslot] if kind == 'moving' else None
            tt, uu, vv, ok, disc = _candidates(
                kind, data[cslot], rows1, org[al], direction[al],
                None if time is None else time[al])
            if want_counts and disc is not None:
                missed[al] += ((cand >= 0) & ~(disc > 0.0)).sum(dim=-1)
            gid = cand + prim_offset
            ok = ok & (cand >= 0) & (tt < t[al][:, None]) & _not_ignored(
                gid, None if ignore_prim is None else ignore_prim[al],
                None if ignore_prim2 is None else ignore_prim2[al])
            if any_hit:
                prim[al[ok.any(dim=-1)]] = 0
            elif kind in ('tri', 'moving'):
                t[al], prim[al], u[al], v[al], slot[al] = _closest_select(
                    tt, ok, t[al], prim[al], u[al], v[al], gid, uu, vv,
                    slot=slot[al], cand_slot=cslot)
            else:    # the slot stays the last triangle winner's
                t[al], prim[al], u[al], v[al] = _closest_select(
                    tt, ok, t[al], prim[al], u[al], v[al], gid, uu, vv)
        nxt = torch.where(box & (first < 0), nd + 1, skip)
        node[act] = nxt
        keep = nxt < n_nodes
        if any_hit:
            keep = keep & (prim[act] < 0)
        act = act[keep]
    if want_counts:
        return t, prim, u, v, slot, visits, leafs, missed
    return t, prim, u, v, slot


def dense_plain(kind, recs, org, direction, t, prim, u, v,
                ignore_prim=None, ignore_prim2=None, time=None, prim_offset=0,
                any_hit=False):
    """Every ray against every prim of a short list, no tree and no box.

    kind 'sphere': recs = (c [S, 3], r [S], c_t1 [S, 3] or None; with
    ``time`` and c_t1 the centres are lerped per ray); kind 'line': recs =
    (v0, v1 [L, 3], r0, r1 [L]).  The running hit and the any-hit
    convention are ``walk_plain``'s; returns (t, prim, u, v)."""
    n_prims = recs[0].shape[0]
    gid = torch.arange(n_prims, device=org.device) + prim_offset
    if kind == 'sphere':
        c, r, c_t1 = recs
        c = c[None]
        if time is not None and c_t1 is not None:
            c = lerp_rows(c, c_t1[None], time[..., None, None])
        tt, ok = ray_sphere_intersect(c, r[None], org, direction)
        uu = None
    else:
        v0, v1, r0, r1 = recs
        tt, uu, ok = ray_cone_intersect(v0[None], v1[None], r0[None],
                                        r1[None], org, direction)
    ok = ok & (tt < t[..., None]) & _not_ignored(gid[None], ignore_prim,
                                                 ignore_prim2)
    if any_hit:
        live = (t > 0) & (prim < 0)
        return (t, torch.where(live & ok.any(dim=-1), 0, prim), u, v)
    return _closest_select(tt, ok, t, prim, u, v, gid.expand(tt.shape), uu)
