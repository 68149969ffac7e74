# Frozen copy of corona13_tpu_torch/ops/bvh.py (lines 1-264) as of commit 2084081, for the benchmark's plain reference.
"""Host-side BVH construction (corona13_tpu/ops/bvh.py), numpy only.

A binned-SAH binary tree flattened in DFS preorder, then collapsed into the
8-wide layout that the traversal kernel walks (``ops/trace_cuda.py``).  The
port carries this copy of the reference's numpy builder so that it runs
without the JAX package; both give bit-identical arrays for the same input
(``tests/test_torch_trace.py``).  The builder runs once per scene at load.

Binary layout (arrays of length = number of nodes, DFS/preorder):
  node_min/max [N, 3]  AABB
  node_skip    [N]     next node when the AABB test fails (or after a leaf)
  node_first   [N]     first entry in ``leaf_prims`` for leaves, -1 for inner
  node_right   [N]     right child (-1 for leaves); the left child is i+1
  leaf_prims   [M]     primitive indices, each leaf padded to LEAF_SIZE with -1
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

LEAF_SIZE = 8   # prims per leaf: the rows of one leaf_packed block
SAH_BINS = 16


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray   # [N, 3] float32
    node_max: np.ndarray   # [N, 3] float32
    node_skip: np.ndarray  # [N] int32
    node_first: np.ndarray # [N] int32 (-1 = inner node)
    node_right: np.ndarray # [N] int32 right child (-1 for leaves)
    leaf_prims: np.ndarray # [M] int32, padded with -1
    n_prims: int


def _empty_bvh() -> FlatBVH:
    return FlatBVH(
        node_min=np.full((1, 3), np.inf, np.float32),
        node_max=np.full((1, 3), -np.inf, np.float32),
        node_skip=np.array([1], np.int32),
        node_first=np.array([0], np.int32),
        node_right=np.array([-1], np.int32),
        leaf_prims=np.full(LEAF_SIZE, -1, np.int32),
        n_prims=0,
    )


def _sah_areas(mins, maxs, counts, rev=False):
    """Prefix (or suffix) surface areas and counts over the SAH bins."""
    if rev:
        mins, maxs, counts = mins[::-1], maxs[::-1], counts[::-1]
    cmin = np.minimum.accumulate(mins, axis=0)
    cmax = np.maximum.accumulate(maxs, axis=0)
    d = np.maximum(cmax - cmin, 0.0)
    sa = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    cnt = np.cumsum(counts)
    if rev:
        sa, cnt = sa[::-1], cnt[::-1]
    return sa, cnt


def _split(idx_set, cent, p_min, p_max):
    """Left-side mask of one node's binned-SAH split along the widest
    centroid axis (median split when the centroids are degenerate)."""
    c = cent[idx_set]
    lo = c.min(axis=0)
    ext = c.max(axis=0) - lo
    axis = int(np.argmax(ext))
    half = len(idx_set) // 2
    left_sel = np.zeros(len(idx_set), bool)
    if ext[axis] <= 1e-12:
        left_sel[:half] = True
        return left_sel
    bins = np.minimum(
        ((c[:, axis] - lo[axis]) / ext[axis] * SAH_BINS).astype(np.int64),
        SAH_BINS - 1)
    bin_count = np.bincount(bins, minlength=SAH_BINS)
    bmin = np.full((SAH_BINS, 3), np.inf, np.float32)
    bmax = np.full((SAH_BINS, 3), -np.inf, np.float32)
    for k in range(3):
        np.minimum.at(bmin[:, k], bins, p_min[idx_set][:, k])
        np.maximum.at(bmax[:, k], bins, p_max[idx_set][:, k])
    sa_l, cnt_l = _sah_areas(bmin, bmax, bin_count)
    sa_r, cnt_r = _sah_areas(bmin, bmax, bin_count, rev=True)
    # cost of splitting after bin k: left = bins[0..k], right = bins[k+1..]
    cost = sa_l[:-1] * cnt_l[:-1] + sa_r[1:] * cnt_r[1:]
    cost = np.where((cnt_l[:-1] == 0) | (cnt_r[1:] == 0), np.inf, cost)
    k = int(np.argmin(cost))
    if not np.isfinite(cost[k]):
        order = np.argsort(c[:, axis], kind='stable')
        left_sel[order[:half]] = True
        return left_sel
    return bins <= k


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray) -> FlatBVH:
    """Binned-SAH binary BVH over primitive AABBs [P, 3] (the reference's
    binned SAH build, qbvhmp.c:93-170)."""
    p_min = np.asarray(prim_min, np.float32)
    p_max = np.asarray(prim_max, np.float32)
    n = len(p_min)
    if n == 0:
        return _empty_bvh()
    cent = 0.5 * (p_min + p_max)

    nodes_min, nodes_max, nodes_first, parent_of, is_right = [], [], [], [], []
    leaf_prims: list[np.ndarray] = []
    # worklist DFS: the left child is processed right after its parent,
    # so the node order is preorder
    stack = [(np.arange(n), -1, False)]
    while stack:
        idx_set, parent, right = stack.pop()
        nodes_min.append(p_min[idx_set].min(axis=0))
        nodes_max.append(p_max[idx_set].max(axis=0))
        nodes_first.append(-1)
        parent_of.append(parent)
        is_right.append(right)
        me = len(nodes_min) - 1
        if len(idx_set) <= LEAF_SIZE:
            nodes_first[me] = len(leaf_prims) * LEAF_SIZE
            pad = np.full(LEAF_SIZE, -1, np.int64)
            pad[:len(idx_set)] = idx_set
            leaf_prims.append(pad)
            continue
        left_sel = _split(idx_set, cent, p_min, p_max)
        stack.append((idx_set[~left_sel], me, True))
        stack.append((idx_set[left_sel], me, False))

    n_nodes = len(nodes_min)
    right_child = np.full(n_nodes, -1, np.int32)
    for i in range(1, n_nodes):
        if is_right[i]:
            right_child[parent_of[i]] = i
    # skip links: left children continue at their right sibling, right
    # children inherit the parent's skip (parents come first in preorder)
    node_skip = np.full(n_nodes, n_nodes, np.int32)
    for i in range(1, n_nodes):
        p = parent_of[i]
        if is_right[i]:
            node_skip[i] = node_skip[p]
        else:
            node_skip[i] = right_child[p] if right_child[p] >= 0 else node_skip[p]
    return FlatBVH(node_min=np.stack(nodes_min).astype(np.float32),
                   node_max=np.stack(nodes_max).astype(np.float32),
                   node_skip=node_skip,
                   node_first=np.asarray(nodes_first, np.int32),
                   node_right=right_child,
                   leaf_prims=np.stack(leaf_prims).reshape(-1).astype(np.int32),
                   n_prims=n)


def collapse8(b: FlatBVH):
    """Collapse the binary BVH into the 8-wide tree of the traversal kernel.

    Returns (wbounds, wlinks, depth):
      wbounds [Wn, 8, 8] f32: per child row [min3, max3, w, pad] with
        w = 2^c for inner children, 256 * 2^c for leaf children and 0 for
        empty slots (inverted boxes);
      wlinks  [Wn * 8] i32: child links (wide node id, or leaf id for a
        leaf child);
      depth   int: the wide tree's depth.  A traversal stack needs at most
        depth * 7 + 8 entries (each inner pop nets at most +7).
    Each wide node greedily opens its largest-area inner slot until it
    holds 8 children; wide nodes are numbered breadth first.
    """
    left = np.where(b.node_first >= 0, -(b.node_first // LEAF_SIZE + 1),
                    np.arange(len(b.node_first), dtype=np.int64) + 1)
    right = b.node_right.astype(np.int64)
    nmin, nmax = b.node_min, b.node_max
    d = np.maximum(nmax - nmin, 0.0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    def children8(bn):
        slots = [bn]
        while len(slots) < 8:
            cands = [(area[s], i) for i, s in enumerate(slots) if left[s] >= 0]
            if not cands:
                break
            _, i = max(cands)
            s = slots.pop(i)
            slots.extend([left[s], right[s]])
        return slots

    wide_children = []
    order = []
    wid_of = {}
    depth_of = {0: 1}
    max_depth = 1
    if left[0] < 0:
        # single-leaf tree: one wide node holding the leaf
        wide_children.append([0])
        order.append(0)
    else:
        queue = deque([0])
        while queue:
            bn = queue.popleft()
            wid_of[bn] = len(order)
            order.append(bn)
            ch = children8(bn)
            wide_children.append(ch)
            for c in ch:
                if left[c] >= 0:
                    depth_of[c] = depth_of[bn] + 1
                    max_depth = max(max_depth, depth_of[c])
                    queue.append(c)
    wn = len(order)
    wbounds = np.zeros((wn, 8, 8), np.float32)
    wbounds[:, :, 0:3] = 3.0e38
    wbounds[:, :, 3:6] = -3.0e38
    wlinks = np.zeros((wn, 8), np.int32)
    for wi, ch in enumerate(wide_children):
        for ci, c in enumerate(ch):
            wbounds[wi, ci, 0:3] = nmin[c]
            wbounds[wi, ci, 3:6] = nmax[c]
            if left[c] < 0:
                wbounds[wi, ci, 6] = float(256 * (1 << ci))
                wlinks[wi, ci] = -left[c] - 1      # leaf id
            else:
                wbounds[wi, ci, 6] = float(1 << ci)
                wlinks[wi, ci] = wid_of[c]
    return wbounds, wlinks.reshape(-1), max_depth


def tri_bounds(tri_vtx: np.ndarray, tri_vtx_t1: np.ndarray | None = None):
    """AABBs of triangles (the union over both shutter times)."""
    lo = tri_vtx.min(axis=1)
    hi = tri_vtx.max(axis=1)
    if tri_vtx_t1 is not None:
        lo = np.minimum(lo, tri_vtx_t1.min(axis=1))
        hi = np.maximum(hi, tri_vtx_t1.max(axis=1))
    return lo, hi

