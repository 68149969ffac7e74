"""BVH traversal: the CUDA kernels' wrappers and their plain versions.

Replaces the Pallas TPU kernel ``corona13_tpu/ops/trace_pallas.py``
(``_kernel`` behind ``traverse_tris``), the only ``pallas_call`` of the
JAX package.  All three specialisations are ported: closest-hit
(``intersect``), any-hit (``occluded``, the NEE shadow ray) and
``want_counters`` (inner-node and leaf pops per 1024-ray block, the
ACCEL_DEBUG analogue; no render path calls it).  The reference arrays are
``collapse8``'s (``ops/bvh.py``): ``wbounds [Wn,8,8]`` child boxes plus
push weights, ``wlinks [Wn*8]`` child links and ``leaf_packed
[n_leaves,8,16]`` rows (v0, e1, e2, prim as f32).  The plain version
walks those; the kernel walks its own repack of them
(``pack_kernel_layout``), made in numpy at upload and kept beside them on
``trace.DeviceBVH``.

What bounds the kernel on the H100: there is no matrix product in a BVH
walk (the 8-child slab test and the 8-row Moeller-Trumbore test are SIMD
inside one thread), so the tensor cores and ``wgmma`` do not apply.  The
floor is bytes on the main path's small trees (about 70 B a ray in and
out) and fp32 operations on deep ones; in practice the kernel waits on
divergent gathers and its stack, and idles on dead lanes and on a warp's
slowest ray.  The design (``csrc/traverse_tris.cu``) goes at each:

- layout: a wide node is one 256 B record of 16 ``float4`` with the child
  link in the reference layout's pad word (no ``wlinks`` gather); a leaf
  row is 3 ``float4`` with the prim id as int bits; every load is 16 B.
- stack: in shared memory, ``[entry][thread]`` (conflict-free), sized per
  launch from the tree's ``wdepth*7 + 8`` entries (``stack_depth``), at
  most ``MAX_STACK``.
- loop: while-while (inner nodes until a leaf is on top, then leaves),
  each thread popping its own entries in the single loop's order.
- rays: closest-hit and any-hit run a persistent grid (6 blocks an SM)
  whose warps fetch 32-ray batches from a counter, write dead rays
  (``t_init <= 0``) out at fetch and compact the live ones onto idle
  lanes, refilling as rays end.  Results do not depend on which lane
  walks a ray: two launches give the same bits.  The counter is an
  int32[2] per device and stream, zeroed once here and left at zero by
  every launch.
- wrapper: the kernel derives the clamped inverse direction, takes the
  ignore ids as int32, int64 or ``None`` and ``t_init`` as a tensor or
  one float, and writes ``prim``/``slot`` as int64 (``occluded_tris``:
  only a bool), so a caller adds no torch pass around the launch.

Order and rounding are the TPU kernel's: children pushed in ascending
child index (its packet order restricted to the ray's own hits), an
exact-t tie between leaves to the first visited, the winner inside a leaf
the minimum of ``(bits(t) & ~7) | k``, ``-fmad=false``.  The per-ray
pop counts (``simple_walk``) keep the simple assignment (thread i walks
ray i) and share the rest.  The line policy's closest-hit walk is
near-first instead (children sorted by entry distance, an entry the
running t has passed dropped at its pop; an exact-t tie between two
fibres may then go to another fibre than the plain walk's), and its
records carry each fibre's own terms of the cone test
(``pack_line_rows``), which the plain walk reads as well.
The moving-triangle policy's closest-hit walk takes the reference's own
order: it walks the nodes with each node's children in reverse binary
preorder (``pack_nodes_preorder``), so that they pop in preorder, and
tests a leaf's box again at its pop, at the running t, so that it tests
the leaves the skip-link walk tests, in its order, and gives its bits on
every ray, ties and hits an ulp before their box included.  Its records (``pack_moving_rows``) give a row a second,
shutter-close record only where the row moves, and a leaf's filled rows.

Build: ``nvcc`` compiles ``csrc/traverse_tris.cu`` (plain C interface)
for sm_90a into ``_build/`` and ``ctypes`` loads it; the launch's
``cudaGetLastError`` comes back as the C function's result and raises.
On a CPU tensor the wrappers run ``traverse_tris_plain``; on a CUDA
tensor they launch the kernel or raise.  ``launches`` counts kernel
launches per specialisation ('closest', 'any', and 'counters' for the
union walk of ``want_counters``, either hit mode), per further form and
per per-ray counting walk ('tri_counters', 'line_counters').

Further forms (``closest_hit``, ``any_hit``).  What the JAX package
serves with XLA's lockstep skip-link ``_traverse`` and its dense
small-list branches, not with Pallas, runs here as more forms of the same
source file, because a lockstep torch loop would wait on the host at every
step: the wide walk with a moving-triangle, a sphere or a cone (line) leaf
policy ('moving', 'sphere', 'line'), for a tree too deep for
``MAX_STACK`` the deep walk ('deep': records that hold both children of a
binary node, ``pack_bin_nodes``, a stack of the tree's binary levels in
shared memory whose entries the running t has passed are dropped at the
pop, persistent warps; the skip-link walk's order, so its bits) or, with
more binary levels than ``MAX_BIN_STACK``, the stackless skip-link walk
over ``DeviceBVH.nodes`` ('skip'), chosen at upload, and
the dense test of a list of at most ``DENSE_MAX`` spheres or lines
('dense_sphere', 'dense_line'), which reads the geometry's own arrays
(a line list: its records with each line's terms, ``pack_dense_lines``)
and is the only form that lerps sphere centres in time.  Their winner is
``_closest_select``'s (smallest t, first row on a tie), not the TPU
kernel's encoding, which stays with the static triangles of the wide walk.
Prim ids are global: a launch takes the kind's offset.
``closest_hit`` / ``any_hit`` serve the static triangles of a wide tree as
well (kind 'tri': the TPU kernel's closest-hit and any-hit specialisations,
counted as 'closest' and 'any'), so ``trace.intersect`` and ``occluded``
are one loop over a scene's prim kinds; ``traverse_tris`` and
``occluded_tris`` remain the TPU kernel's own interface (``want_counters``,
the tests against interpret mode).  One
``trace.intersect`` call chains its kinds through ``carry``: a launch
starts from the running (t, prim, u, v, slot), or the blocked flags, of
the launches before it and updates them in place where it finds better,
so no torch pass runs between them.  Their plain versions are
``trace_plain.walk_plain`` and ``dense_plain`` (``traverse_tris_plain`` for
the static triangles of a wide tree), reached through
``closest_hit_plain`` / ``any_hit_plain`` and, on a CPU tensor, through the
wrappers themselves.

Counters (``want_counters``).  The TPU kernel counts the pops of a
128-ray tile that walks the union of its rays' hits, so no per-ray walk
gives its numbers: ``traverse_tris(..., want_counters=True)`` walks that
union, as ``union_kernel`` on the card (one ray a thread, 128 threads a
tile; see the source note) and as ``union_walk_plain`` on the CPU.  Its
counts are the TPU kernel's on every block, and so are its hits, exact-t
ties included: every lane of a tile tests every leaf the union reaches, in
the union's order.  The render launches walk each ray alone, so on a tie
between two leaves (a ray aimed at an edge that two leaves share) their
winner can differ from the counters launch's; in the JAX package both
come from the union walk.  ``simple_walk`` keeps the per-ray walk with
each ray's own pops ('tri_counters', 'line_counters'): the yardstick of
the persistent launches, and the pops that bound them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from . import trace_plain
from .bvh import LEAF_SIZE as LEAF
from .trace_plain import inv_dir  # noqa: F401  (the plain version's)

MAX_STACK = 192  # stack entries a thread can have: 96 KB of shared memory
# the deep walk's stack entries a thread (4 B each: 96 KB a block at most)
MAX_BIN_STACK = 192
K_MASK = 7       # low mantissa bits that carry the winning leaf row
NO_HIT = 0x7f000000
BLOCK = 1024     # rays per counter block (the TPU kernel's grid step)
TILE = 128       # rays that walk one union (the TPU kernel's lane axis)
LEAF_ROW = 12    # floats per triangle leaf row in the kernel layout
DENSE_MAX = 64   # prims a dense list can hold (trace.BRUTE_FORCE_MAX)
# floats per leaf row of each kind's kernel records (float4 multiples)
ROW_FLOATS = {'tri': 12, 'moving': 12, 'sphere': 4, 'line': 12}
_FORMS = {'wide': 0, 'deep': 1, 'dense': 2, 'skip': 3, 'union': 4}
# the kinds whose wide closest-hit walk takes the reference's order: nodes
# in preorder (knodes_pre), the box tested again at a leaf's pop
PREORDER_KINDS = ('moving', 'sphere')
_KINDS = {'tri': 0, 'moving': 1, 'sphere': 2, 'line': 3}

# kernel launches per form: the TPU kernel's three specialisations
# ('closest', 'any': static triangles, wide walk; 'counters': the union
# walk), then the forms that replace XLA's _traverse, each closest-hit and
# any-hit: the wide walk with the moving-triangle, sphere and line
# policies, the deep-tree walk and, for a tree too deep for its stack, the
# stackless skip-link walk (any policy), and the dense sphere and line
# lists; and the per-ray walks with their pops (simple_walk: 'tri_counters',
# 'line_counters')
launches = {k: 0 for k in (
    'closest', 'any', 'counters',
    *(f'{f}_{m}' for f in ('moving', 'sphere', 'line', 'deep', 'skip',
                           'dense_sphere', 'dense_line')
      for m in ('closest', 'any')),
    'tri_counters', 'line_counters')}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
_BUILD = os.path.join(os.path.dirname(_CSRC), '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')
_fn = None       # the loaded library's entry point
_work = {}       # (device, stream) -> the persistent launches' int32[2]
build_log = ''   # nvcc's report (registers, spills) on the library in use


class _Args(ctypes.Structure):
    """Corona13TraceArgs of csrc/traverse_tris.cu, field for field."""
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _fields_ = [
        ('form', _i), ('kind', _i), ('any_hit', _i), ('carry', _i),
        ('nodes', _p), ('leaves', _p), ('leaves_t1', _p), ('ids', _p),
        ('depth', _i),
        ('n_nodes', _i), ('d0', _p), ('d1', _p), ('d2', _p),
        ('n_prims', _i), ('prim_offset', _i), ('org', _p), ('dir', _p),
        ('time', _p), ('t_init', _p), ('t_all', _f), ('ignore_is64', _i),
        ('ignore1', _p), ('ignore2', _p), ('n', _i), ('t_out', _p),
        ('prim_out', _p), ('u_out', _p), ('v_out', _p), ('slot_out', _p),
        ('blocked_out', _p), ('iters_out', _p), ('leafs_out', _p),
        ('work', _p), ('stream', _p)]


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ([os.path.join(home, 'bin', 'nvcc')] if home else []) + [
            shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('traverse_tris: no nvcc to build the CUDA kernel with')


def build():
    """Compile ``csrc/traverse_tris.cu`` for sm_90a with nvcc into
    ``_build/`` (named by a hash of the source and flags, so an up-to-date
    library is reused) and load it with ctypes, once per process."""
    global build_log, _fn
    if _fn is not None:
        return _fn
    src = os.path.join(_CSRC, 'traverse_tris.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha1(f.read() + repr(NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD,
                            f'libtraverse_tris_{digest.hexdigest()[:12]}.so')
    if not os.path.exists(lib_path):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f'{lib_path}.{os.getpid()}.tmp'
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                             capture_output=True, text=True)
        build_log = out.stdout + out.stderr
        if out.returncode != 0:
            raise RuntimeError(f'traverse_tris: nvcc failed:\n{build_log}')
        with open(lib_path + '.log', 'w') as f:
            f.write(build_log)
        os.replace(tmp, lib_path)
    else:
        with open(lib_path + '.log') as f:
            build_log = f.read()
    fn = ctypes.CDLL(lib_path).corona13_trace
    fn.argtypes = [ctypes.POINTER(_Args)]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


# --- the kernel's own layout -------------------------------------------------

def stack_depth(wdepth: int) -> int | None:
    """Stack entries a thread needs for a wide tree of depth ``wdepth``:
    each inner pop nets at most +7, so wdepth*7 + 8.  None above
    ``MAX_STACK``: such a tree gets no wide layout."""
    need = int(wdepth) * 7 + 8
    return need if need <= MAX_STACK else None


def wide_depth(wbounds: np.ndarray, wlinks: np.ndarray) -> int:
    """Depth of the wide tree (collapse8's third result) from its arrays."""
    w = wbounds[:, :, 6]
    inner = (w > 0.0) & (w < 256.0)
    links = wlinks.reshape(-1, 8)
    depth, level = 0, np.array([0])
    while level.size:
        depth += 1
        level = links[level][inner[level]]
    return depth


def preorder_ranks(wbounds: np.ndarray, wlinks: np.ndarray) -> np.ndarray:
    """[Wn, 8] int: each child's rank among its node's children in the
    binary tree's preorder (0 first), which the skip-link walk follows.
    A child's place there is the least leaf id below it: ``build_bvh``
    numbers leaves in preorder and a subtree's leaves are consecutive.
    Empty slots rank last."""
    w = wbounds[:, :, 6]
    links = np.ascontiguousarray(wlinks, np.int32).reshape(-1, 8)
    key = np.full(w.shape, np.iinfo(np.int64).max, np.int64)
    least = np.zeros(len(w), np.int64)
    for i in range(len(w) - 1, -1, -1):   # breadth first: children later
        leaf, inner = w[i] >= 256.0, (w[i] > 0.0) & (w[i] < 256.0)
        key[i, leaf] = links[i, leaf]
        key[i, inner] = least[links[i, inner]]
        least[i] = key[i].min()
    return np.argsort(np.argsort(key, axis=1, kind='stable'), axis=1,
                      kind='stable')


def pack_nodes(wbounds: np.ndarray, wlinks: np.ndarray,
               filled: np.ndarray | None = None) -> np.ndarray:
    """knodes [Wn, 8, 8] f32: per child min3, max3, push weight, and the
    child's link as int32 bits in the reference pad word: one
    16-byte-aligned 256 B record a node, read as 16 float4.  ``filled``
    (the sphere form's nodes: each leaf's filled rows [n_leaves]): a leaf
    child's link is lid * 8 + filled[lid] - 1, so that the pop of a leaf
    knows its rows from its entry."""
    knodes = np.ascontiguousarray(wbounds, np.float32).copy()
    links = np.ascontiguousarray(wlinks, np.int32).reshape(-1, 8).copy()
    if filled is not None:
        leaf = knodes[:, :, 6] >= 256.0
        links[leaf] = links[leaf] * LEAF + np.asarray(
            filled, np.int32)[links[leaf]] - 1
    knodes[:, :, 7] = links.view(np.float32)
    return knodes


def leaf_fill(leaf_prims: np.ndarray) -> np.ndarray:
    """Each leaf's filled rows [n_leaves] int32 from the leaf-slot-major
    prim ids (-1: padding, which ``bvh.build_bvh`` puts at a leaf's end)."""
    return (np.asarray(leaf_prims).reshape(-1, LEAF) >= 0).sum(
        axis=1).astype(np.int32)


def pack_nodes_preorder(wbounds: np.ndarray, wlinks: np.ndarray,
                        filled: np.ndarray | None = None) -> np.ndarray:
    """The moving and sphere forms' closest-hit nodes: ``pack_nodes``'
    records with each node's children in reverse binary preorder
    (``preorder_ranks``; empty slots first), so that the walk, which
    pushes a node's hit children in ascending slot, pops them in the
    skip-link walk's order.  Node ids, and so the links, are
    ``pack_nodes``'."""
    knodes = pack_nodes(wbounds, wlinks, filled)
    order = np.argsort(-preorder_ranks(wbounds, wlinks), axis=1,
                       kind='stable')
    return np.take_along_axis(knodes, order[:, :, None], axis=1)


def bin_depth(nodes: np.ndarray) -> int:
    """Levels of the binary tree of ``DeviceBVH.nodes`` [N, 8] (min3,
    max3, skip and first as int32 bits; a lone root leaf: 1).  The deep
    walk's stack holds at most one entry a level above the leaves."""
    nodes = np.ascontiguousarray(nodes, np.float32)
    skip = nodes[:, 6].copy().view(np.int32)
    first = nodes[:, 7].copy().view(np.int32)
    depth = np.ones(len(nodes), np.int64)
    for i in np.nonzero(first < 0)[0]:    # preorder: parents first
        depth[i + 1] = depth[skip[i + 1]] = depth[i] + 1
    return int(depth.max())


def pack_bin_nodes(nodes: np.ndarray, leaf_prims: np.ndarray) -> np.ndarray:
    """The deep walk's records [1 + inner nodes, 16] f32 from
    ``DeviceBVH.nodes`` [N, 8] and the leaf-slot-major prim ids (-1:
    padding).  Record r >= 1 is the r-th inner node in preorder (the left
    child of an inner node, when inner, is the next record) and holds both
    children:

        left min.xyz, left max.x | left max.yz, right min.xy |
        right min.z, right max.xyz | left link, right link, 0, 0

    (links as int32 bits): an inner child's record, or -code - 1 for a
    leaf child, code = leaf id * 8 + filled rows - 1 (at least one row,
    which an empty leaf's padding misses).  Record 0 holds the root, whose
    box the walk tests first, as a left child alone: root min.xyz, root
    max.x | root max.yz, root link, 0 | 0 ... | root link, 0, 0, 0.  No
    link is 0, which the walk reads as 'none'."""
    nodes = np.ascontiguousarray(nodes, np.float32)
    skip = nodes[:, 6].copy().view(np.int32)
    first = nodes[:, 7].copy().view(np.int32)
    inner = np.nonzero(first < 0)[0]
    rec_of = np.zeros(len(nodes), np.int64)
    rec_of[inner] = np.arange(1, len(inner) + 1)
    lid = np.maximum(first, 0) // LEAF
    fill = np.maximum(leaf_fill(leaf_prims), 1)
    link = np.where(first >= 0, -(lid * LEAF + fill[lid] - 1) - 1,
                    rec_of).astype(np.int32)
    box = nodes[:, 0:6]
    rec = np.zeros((len(inner) + 1, 16), np.float32)
    left, right = inner + 1, skip[inner + 1]
    rec[1:, 0:6], rec[1:, 6:12] = box[left], box[right]
    rec[1:, 12] = link[left].view(np.float32)
    rec[1:, 13] = link[right].view(np.float32)
    rec[0, 0:6] = box[0]
    rec[0, 6] = rec[0, 12] = link[0:1].view(np.float32)[0]
    return rec


def unpack_bin_nodes(bnodes: np.ndarray):
    """The binary tree behind ``pack_bin_nodes``' records, in preorder:
    (node_min [N, 3], node_max [N, 3], node_first [N] (-1 inner), node_right
    [N] (-1 leaf), each leaf's filled rows [n_leaves] in leaf order)."""
    rec = np.ascontiguousarray(bnodes, np.float32)
    links = rec[:, 12:14].copy().view(np.int32)
    box, first, right, fill = [], [], [], {}
    todo = [(rec[0, 0:6], links[0, 0], -1)]    # (box, link, parent if right)
    while todo:
        b, link, parent = todo.pop()
        me = len(box)
        box.append(b)
        right.append(-1)
        if parent >= 0:
            right[parent] = me
        if link < 0:
            code = -int(link) - 1
            first.append(code // LEAF * LEAF)
            fill[code // LEAF] = code % LEAF + 1
            continue
        first.append(-1)
        todo.append((rec[link, 6:12], links[link, 1], me))
        todo.append((rec[link, 0:6], links[link, 0], -1))
    box = np.stack(box)
    return (box[:, 0:3], box[:, 3:6], np.asarray(first, np.int32),
            np.asarray(right, np.int32),
            np.asarray([fill[i] for i in sorted(fill)], np.int32))


def pack_leaf_rows(kind: str, leaf_data: np.ndarray,
                   leaf_prims: np.ndarray) -> np.ndarray:
    """One kind's leaf-slot-major rows [slots, D] and local prim ids
    [slots] (-1: padding) -> the kernel's records [n_leaves, 8, ROW], every
    row a whole number of float4:

    'tri' (and each shutter time of 'moving'), D = 9, the id as int32 bits:
        v0.xyz, id | e1.xyz, 0 | e2.xyz, 0
    'sphere', D = 4:  c.xyz, r
        (16 B a row: the ids stay in the tree's ``leaf_prims``, which the
        kernel reads for a row that is hit)
    Lines have their own records (``pack_line_rows``)."""
    d = np.ascontiguousarray(leaf_data, np.float32)
    ids = np.ascontiguousarray(leaf_prims).astype(np.int32).view(np.float32)
    rows = np.zeros((d.shape[0], ROW_FLOATS[kind]), np.float32)
    if kind in ('tri', 'moving'):
        rows[:, 0:3], rows[:, 3] = d[:, 0:3], ids
        rows[:, 4:7], rows[:, 8:11] = d[:, 3:6], d[:, 6:9]
    elif kind == 'sphere':
        rows[:, :] = d
    else:
        raise ValueError(f'pack_leaf_rows: no rows of kind {kind!r} here')
    return rows.reshape(-1, LEAF, ROW_FLOATS[kind])


def pack_moving_rows(leaf_data: np.ndarray, leaf_data_t1: np.ndarray,
                     leaf_prims: np.ndarray):
    """A moving triangle BVH's leaf-slot-major rows at shutter open and
    close [slots, 9] and local prim ids [slots] (-1: padding) -> the
    kernel's records (kleaves [n_leaves, 8, 12], kleaves_t1 [M, 12]):

        kleaves:    v0.xyz, id | e1.xyz, moved | e2.xyz, filled rows
        kleaves_t1: v0.xyz, 0  | e1.xyz, 0     | e2.xyz, 0

    (ints as their bits).  A slot moves where its nine shutter-close
    floats differ from its shutter-open ones in a bit; ``moved`` is its
    index into kleaves_t1, which holds the moving slots' shutter-close
    rows in slot order, or -1 for a slot that does not move (the kernel
    then lerps its one record with itself).  kleaves_t1 keeps one zero row
    when no slot moves.  ``filled``: the filled rows of the slot's leaf,
    which come first (``bvh.build_bvh`` pads at the end).  The inverse of
    ``unpack_moving_rows``."""
    d0 = np.ascontiguousarray(leaf_data, np.float32)
    d1 = np.ascontiguousarray(leaf_data_t1, np.float32)
    rows = pack_leaf_rows('moving', d0, leaf_prims).reshape(-1, 12)
    moves = (d0.view(np.int32) != d1.view(np.int32)).any(axis=1)
    moved = np.where(moves, np.cumsum(moves) - 1, -1).astype(np.int32)
    filled = (np.asarray(leaf_prims).reshape(-1, LEAF) >= 0).sum(axis=1)
    rows[:, 7] = moved.view(np.float32)
    rows[:, 11] = np.repeat(filled.astype(np.int32), LEAF).view(np.float32)
    m = d1[moves]
    t1 = np.zeros((max(len(m), 1), 12), np.float32)
    t1[:len(m), 0:3], t1[:len(m), 4:7], t1[:len(m), 8:11] = \
        m[:, 0:3], m[:, 3:6], m[:, 6:9]
    return rows.reshape(-1, LEAF, 12), t1


def unpack_moving_rows(kleaves, kleaves_t1):
    """The inverse of ``pack_moving_rows``: (leaf_data, leaf_data_t1,
    leaf_prims) as numpy, bit for bit."""
    rows = np.ascontiguousarray(kleaves, np.float32).reshape(-1, 12)
    t1 = np.ascontiguousarray(kleaves_t1, np.float32).reshape(-1, 12)
    data = lambda r: np.concatenate([r[:, 0:3], r[:, 4:7], r[:, 8:11]], 1)
    moved = rows[:, 7].copy().view(np.int32)
    d0 = data(rows)
    d1 = np.where((moved >= 0)[:, None], data(t1)[np.maximum(moved, 0)], d0)
    return d0, d1, rows[:, 3].copy().view(np.int32)


def line_rows(v0, ids, axis, r0, length, k, kk, filled):
    """The kernel's line records [n_leaves, 8, 12] from their fields, one
    entry a leaf slot: v0 [S, 3], ids [S] int32 (-1: padding), the unit
    axis [S, 3], r0, length, k, k*k [S] f32 and the filled rows of the
    slot's leaf [S] int32:
        v0.xyz, id | axis.xyz, r0 | length, k, k*k, filled rows
    (ints as their bits).  The inverse of ``unpack_line_rows``."""
    return _line_records(v0, ids, axis, r0, length, k, kk, filled).reshape(
        -1, LEAF, ROW_FLOATS['line'])


def _line_records(v0, ids, axis, r0, length, k, kk, last):
    """[S, 12] line records from their fields (``line_rows``)."""
    col = lambda x: x.reshape(-1, 1)
    return torch.cat([v0, col(ids.view(torch.float32)), axis, col(r0),
                      col(length), col(k), col(kk),
                      col(last.view(torch.float32))], dim=1)


def unpack_line_rows(rows):
    """The fields of the kernel's line records, as ``line_rows`` takes
    them, bit for bit."""
    r = rows.reshape(-1, ROW_FLOATS['line'])
    as_int = lambda x: x.contiguous().view(torch.int32)
    return (r[:, 0:3], as_int(r[:, 3]), r[:, 4:7], r[:, 7], r[:, 8], r[:, 9],
            r[:, 10], as_int(r[:, 11]))


def pack_line_rows(leaf_data, leaf_prims):
    """A line BVH's leaf-slot-major rows [slots, 8] (v0, v1, r0, r1) and
    local prim ids [slots] (-1: padding), tensors on the device the
    records are for -> the kernel's records (``line_rows``).  Each prim's
    own terms of the cone test (``trace_plain.line_terms``) are computed
    here once, by torch on that device: the bits the reference test
    computes there for every ray, which the kernel and the plain walk then
    both read.  Filled rows come first in a leaf (``bvh.build_bvh`` pads
    at the end), so a leaf pop tests only the first ``filled``."""
    d = leaf_data.to(torch.float32)
    v0, r0 = d[:, 0:3].contiguous(), d[:, 6].contiguous()
    axis, length, k, kk = trace_plain.line_terms(v0, d[:, 3:6], r0, d[:, 7])
    ids = leaf_prims.to(torch.int32)
    filled = (ids.reshape(-1, LEAF) >= 0).sum(dim=1, dtype=torch.int32)
    return line_rows(v0, ids, axis, r0, length, k, kk,
                     filled.repeat_interleave(LEAF))


def pack_dense_lines(v0, v1, r0, r1):
    """A dense line list (v0, v1 [L, 3], r0, r1 [L], L <= DENSE_MAX) on
    the device the records are for -> its records [L, 12], laid out as
    ``line_rows``: each line's own terms of the cone test
    (``trace_plain.line_terms``, computed once, by torch on that device;
    the bits the reference's dense branch computes there for every ray),
    the line's index in the list as its id and L in the last word.  The
    dense kernel and ``trace_plain.dense_plain`` both read them."""
    axis, length, k, kk = trace_plain.line_terms(v0, v1, r0, r1)
    n = v0.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=v0.device)
    count = torch.full((n,), n, dtype=torch.int32, device=v0.device)
    return _line_records(v0, ids, axis, r0, length, k, kk, count)


def pack_kernel_layout(wbounds: np.ndarray, wlinks: np.ndarray,
                       leaf_packed: np.ndarray):
    """collapse8's triangle arrays -> the kernel's records (numpy, at
    upload): (knodes, kleaves) as ``pack_nodes`` and ``pack_leaf_rows``
    lay them out."""
    lp = leaf_packed.reshape(-1, 16)
    return pack_nodes(wbounds, wlinks), pack_leaf_rows(
        'tri', lp[:, 0:9], lp[:, 9].astype(np.int32))


def unpack_kernel_layout(knodes: np.ndarray, kleaves: np.ndarray):
    """The inverse of ``pack_kernel_layout``: (wbounds, wlinks,
    leaf_packed), bit for bit."""
    wbounds = knodes.copy()
    wbounds[:, :, 7] = 0.0
    wlinks = np.ascontiguousarray(knodes[:, :, 7]).view(np.int32).reshape(-1)
    leaf_packed = np.zeros((kleaves.shape[0], LEAF, 16), np.float32)
    leaf_packed[:, :, 0:3] = kleaves[:, :, 0:3]
    leaf_packed[:, :, 3:6] = kleaves[:, :, 4:7]
    leaf_packed[:, :, 6:9] = kleaves[:, :, 8:11]
    leaf_packed[:, :, 9] = np.ascontiguousarray(
        kleaves[:, :, 3]).view(np.int32).astype(np.float32)
    return wbounds, wlinks, leaf_packed


def _check_tensors(want, dev):
    """Each (name, tensor, dtypes, shape or None): on ``dev``, of one of
    the dtypes, of that shape, contiguous."""
    for name, x, dtypes, shape in want:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f'traverse_tris: {name} is {type(x).__name__}, '
                            'needs a tensor')
        if x.device != dev:
            raise ValueError(f'traverse_tris: {name} on {x.device}, '
                             f'rays on {dev}')
        if x.dtype not in dtypes:
            raise TypeError(f'traverse_tris: {name} is {x.dtype}, '
                            f'needs {" or ".join(map(str, dtypes))}')
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f'traverse_tris: {name} has shape '
                             f'{tuple(x.shape)}, needs {shape}')
        if not x.is_contiguous():
            raise ValueError(f'traverse_tris: {name} is not contiguous')


def _check_rays(org, direction, t_init, ignore_prim, ignore_prim2, time=None):
    """Raise on rays the kernel does not take; returns the ray count."""
    if org.dim() != 2 or org.shape[1] != 3:
        raise ValueError(f'traverse_tris: org has shape {tuple(org.shape)}, '
                         'needs (N, 3)')
    n = org.shape[0]
    f32, int_ids = (torch.float32,), (torch.int32, torch.int64)
    want = [('org', org, f32, (n, 3)), ('direction', direction, f32, (n, 3))]
    if isinstance(t_init, torch.Tensor):
        want.append(('t_init', t_init, f32, (n,)))
    if ignore_prim is not None:
        want.append(('ignore_prim', ignore_prim, int_ids, (n,)))
    if ignore_prim2 is not None:
        want.append(('ignore_prim2', ignore_prim2, int_ids, (n,)))
    if time is not None:
        want.append(('time', time, f32, (n,)))
    _check_tensors(want, org.device)
    if (ignore_prim is not None and ignore_prim2 is not None
            and ignore_prim.dtype != ignore_prim2.dtype):
        raise TypeError('traverse_tris: ignore_prim and ignore_prim2 differ '
                        'in dtype')
    return n


def _check_wide_tris(bvh, dev):
    """The reference arrays of a triangle BVH, as traverse_tris takes them."""
    wb, wl, lp = bvh.wbounds, bvh.wlinks, bvh.leaf_packed
    _check_tensors([('wbounds', wb, (torch.float32,), None),
                    ('wlinks', wl, (torch.int32,), None),
                    ('leaf_packed', lp, (torch.float32,), None)], dev)
    if wb.dim() != 3 or tuple(wb.shape[1:]) != (8, 8):
        raise ValueError(f'traverse_tris: wbounds shape {tuple(wb.shape)}')
    if tuple(wl.shape) != (wb.shape[0] * 8,):
        raise ValueError(f'traverse_tris: wlinks shape {tuple(wl.shape)}')
    if lp.dim() != 3 or tuple(lp.shape[1:]) != (LEAF, 16):
        raise ValueError(f'traverse_tris: leaf_packed shape {tuple(lp.shape)}')


def _check_carry(carry, any_hit, n, dev):
    """The running hit of an earlier launch: (t, prim, u, v, slot), or the
    blocked flags of an any-hit call."""
    f32, i64 = (torch.float32,), (torch.int64,)
    if any_hit:
        _check_tensors([('carry', carry, (torch.bool,), (n,))], dev)
        return
    if not isinstance(carry, (tuple, list)) or len(carry) != 5:
        raise ValueError('traverse_tris: carry needs (t, prim, u, v, slot)')
    _check_tensors([(f'carry[{k}]', x, dt, (n,)) for k, (x, dt) in enumerate(
        zip(carry, (f32, i64, f32, f32, i64)))], dev)


def _check_dense(kind, recs, dev):
    """A dense list's arrays; returns its prim count."""
    if kind not in ('sphere', 'line'):
        raise ValueError(f'traverse_tris: no dense form for kind {kind!r}')
    f32 = (torch.float32,)
    if len(recs) != (3 if kind == 'sphere' else 1):
        raise ValueError(f'traverse_tris: {len(recs)} arrays for a dense '
                         f'{kind} list')
    k = recs[0].shape[0] if isinstance(recs[0], torch.Tensor) else -1
    if not 1 <= k <= DENSE_MAX:
        raise ValueError(f'traverse_tris: a dense list of {k} prims, needs '
                         f'1 to {DENSE_MAX}')
    if kind == 'sphere':
        want = [('sph_c', recs[0], f32, (k, 3)), ('sph_r', recs[1], f32, (k,))]
        if recs[2] is not None:
            want.append(('sph_c_t1', recs[2], f32, (k, 3)))
    else:
        want = [('line records', recs[0], f32, (k, ROW_FLOATS['line']))]
    _check_tensors(want, dev)
    return k


def _check_bvh(bvh, kind, form, dev):
    """The kernel records of ``bvh`` for one kind and form."""
    if kind not in _KINDS:
        raise ValueError(f'traverse_tris: unknown kind {kind!r}')
    kl = bvh.kleaves
    f32 = (torch.float32,)
    if not isinstance(kl, torch.Tensor) or kl.dim() != 3:
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         'for this device (kleaves)')
    shape = (kl.shape[0], LEAF, ROW_FLOATS[kind])
    want = [('kleaves', kl, f32, shape)]
    if kind == 'moving':
        t1 = bvh.kleaves_t1
        if not isinstance(t1, torch.Tensor) or t1.dim() != 2:
            raise ValueError('traverse_tris: the BVH carries no moving '
                             'records for this device (kleaves_t1)')
        want.append(('kleaves_t1', t1, f32, (t1.shape[0], ROW_FLOATS[kind])))
    if form == 'wide':
        kn = bvh.knodes
        if not isinstance(kn, torch.Tensor) or kn.dim() != 3:
            raise ValueError('traverse_tris: the BVH carries no kernel '
                             'layout for this device (knodes)')
        want.append(('knodes', kn, f32, (kn.shape[0], 8, 8)))
        if kind in PREORDER_KINDS:
            want.append(('knodes_pre', bvh.knodes_pre, f32, tuple(kn.shape)))
        if not 1 <= bvh.stack_depth <= MAX_STACK:
            raise ValueError(f'traverse_tris: stack depth {bvh.stack_depth}')
    elif form == 'deep':
        want.append(('bnodes', bvh.bnodes, f32, (bvh.bnodes.shape[0], 16)))
        if not 1 <= bvh.bin_depth <= MAX_BIN_STACK:
            raise ValueError(f'traverse_tris: deep stack {bvh.bin_depth}')
    else:
        want.append(('nodes', bvh.nodes, f32, (bvh.nodes.shape[0], 8)))
    if kind == 'sphere':
        want.append(('leaf_prims', bvh.leaf_prims, (torch.int64,),
                     (kl.shape[0] * LEAF,)))
    try:
        _check_tensors(want, dev)
    except (TypeError, ValueError) as e:
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         f'for this device ({e})') from None


def _fresh_hit(n, t_init, dev):
    """The hit record no launch has touched: (t_init, -1, 0, 0, -1)."""
    if isinstance(t_init, torch.Tensor):
        t = t_init.clone()
    else:
        t = torch.full((n,), float(t_init), dtype=torch.float32, device=dev)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    return t, none, zero, zero.clone(), none.clone()


def _launch(form, kind, org, direction, t_init, ignore_prim, ignore_prim2, n,
            any_hit, *, bvh=None, recs=(), time=None, prim_offset=0,
            carry=None, want_counters=False, blocked_only=False, key):
    """Launch one kernel form on CUDA tensors already checked; returns the
    raw outputs: ``blocked`` (bool) if blocked_only, else (t, prim, u, v,
    slot) plus (iters, leafs) with want_counters (per ray, or per block
    for the union form).  With ``carry`` (the running hit, or the blocked
    flags) the launch updates those tensors in place and returns them.
    ``key``: the entry of ``launches`` that counts it."""
    dev = org.device
    if n >= 1 << 30:
        raise ValueError(f'traverse_tris: {n} rays in one launch')
    fn = build()
    ptr = lambda x: None if x is None else x.data_ptr()
    f32 = dict(dtype=torch.float32, device=dev)
    t_tensor = t_init if isinstance(t_init, torch.Tensor) else None
    ids = ignore_prim if ignore_prim is not None else ignore_prim2
    t = prim = u = v = slot = blocked = iters = leafs = work = None
    if blocked_only:
        blocked = carry if carry is not None else torch.empty(
            n, dtype=torch.bool, device=dev)
    elif carry is not None:
        t, prim, u, v, slot = carry
    else:
        t, u, v = (torch.empty(n, **f32) for _ in range(3))
        prim = torch.empty(n, dtype=torch.int64, device=dev)
        slot = torch.empty(n, dtype=torch.int64, device=dev)
    if want_counters:   # per ray, or per block for the union walk
        size = -(-n // BLOCK) if form == 'union' else n
        iters = torch.empty(size, dtype=torch.int32, device=dev)
        leafs = torch.empty(size, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form in ('wide', 'deep') and not want_counters:
        # the persistent launch's work counters: zeroed once here, left at
        # zero again by every launch, so launches of one stream share them
        work = _work.get((dev, stream))
        if work is None:
            work = _work[(dev, stream)] = torch.zeros(
                2, dtype=torch.int32, device=dev)
    a = _Args(form=_FORMS[form], kind=_KINDS[kind], any_hit=int(bool(any_hit)),
              carry=int(carry is not None), prim_offset=int(prim_offset),
              org=org.data_ptr(), dir=direction.data_ptr(), time=ptr(time),
              t_init=ptr(t_tensor),
              t_all=0.0 if t_tensor is not None else float(t_init),
              ignore_is64=int(ids is not None and ids.dtype == torch.int64),
              ignore1=ptr(ignore_prim), ignore2=ptr(ignore_prim2), n=n,
              t_out=ptr(t), prim_out=ptr(prim), u_out=ptr(u), v_out=ptr(v),
              slot_out=ptr(slot), blocked_out=ptr(blocked),
              iters_out=ptr(iters), leafs_out=ptr(leafs), work=ptr(work),
              stream=stream)
    if form == 'dense':
        a.n_prims = recs[0].shape[0]
        a.d0 = ptr(recs[0])
        if kind == 'sphere':
            a.d1, a.d2 = ptr(recs[1]), ptr(recs[2])
    else:
        a.leaves = bvh.kleaves.data_ptr()
        a.leaves_t1 = ptr(bvh.kleaves_t1) if kind == 'moving' else None
        a.ids = ptr(bvh.leaf_prims) if kind == 'sphere' else None
        if form in ('wide', 'union'):
            # the moving and sphere forms' closest-hit pops children in
            # preorder
            pre = kind in PREORDER_KINDS and not any_hit
            nodes = bvh.knodes_pre if pre else bvh.knodes
            a.nodes, a.depth = nodes.data_ptr(), bvh.stack_depth
        elif form == 'deep':
            a.nodes, a.depth = bvh.bnodes.data_ptr(), bvh.bin_depth
        else:
            a.nodes, a.n_nodes = bvh.nodes.data_ptr(), bvh.nodes.shape[0]
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(a))
    if err != 0:
        raise RuntimeError(f'traverse_tris: the kernel launch failed with '
                           f'CUDA error {err}')
    launches[key] += 1
    if blocked_only:
        return blocked
    if want_counters:
        return t, prim, u, v, slot, iters, leafs
    return t, prim, u, v, slot


def _launch_tris(bvh, org, direction, t_init, ignore_prim, ignore_prim2, n,
                 any_hit, walk='persistent', blocked_only=False):
    """The TPU kernel's specialisations on static triangles: the persistent
    wide walk ('closest', 'any'), the union walk of 128-ray tiles
    ('counters') or the per-ray walk with its own pops ('tri_counters')."""
    _check_bvh(bvh, 'tri', 'wide', org.device)
    if tuple(bvh.knodes.shape) != tuple(bvh.wbounds.shape) or \
            bvh.kleaves.shape[0] != bvh.leaf_packed.shape[0]:
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         'for this device (knodes, kleaves)')
    form, key = {'persistent': ('wide', 'any' if any_hit else 'closest'),
                 'union': ('union', 'counters'),
                 'simple': ('wide', 'tri_counters')}[walk]
    return _launch(form, 'tri', org, direction, t_init, ignore_prim,
                   ignore_prim2, n, any_hit, bvh=bvh,
                   want_counters=walk != 'persistent',
                   blocked_only=blocked_only, key=key)


def traverse_tris(bvh, org, direction, t_init, ignore_prim=None,
                  ignore_prim2=None, any_hit=False, want_counters=False):
    """Closest-hit (or any-hit) triangle traversal for a ray wavefront.

    ``bvh``: a ``trace.DeviceBVH`` with its wide layout (``wbounds``,
    ``wlinks``, ``leaf_packed``; on the card also ``knodes``, ``kleaves``
    and ``stack_depth``).  org/direction [N, 3] f32; t_init [N] f32 or one
    float for all rays (exclusive upper bound; lanes with t_init <= 0 do
    no work); ignore_prim(2) [N] int32 or int64, or None.  Returns
    (t, prim, u, v, slot): prim/slot int64, prim = -1 for misses,
    slot = leaf_id*8 + row.  any_hit: prim = 0 and t = -1 on blocked lanes.
    want_counters: the TPU kernel's union walk of 128-ray tiles
    (``union_kernel`` on the card, ``union_walk_plain`` on the CPU), with
    (iters, leafs) [ceil(N/BLOCK)] i32 appended: the inner-node and leaf
    pops of each 1024-ray block's tiles (see the module docstring)."""
    n = _check_rays(org, direction, t_init, ignore_prim, ignore_prim2)
    _check_wide_tris(bvh, org.device)
    if org.device.type == 'cpu':
        return traverse_tris_plain(bvh.wbounds, bvh.wlinks, bvh.leaf_packed,
                                   org, direction, t_init, ignore_prim,
                                   ignore_prim2, any_hit=any_hit,
                                   want_counters=want_counters)
    if org.device.type != 'cuda':
        raise ValueError(f'traverse_tris: no kernel for {org.device}')
    if n == 0:
        f32 = dict(dtype=torch.float32, device=org.device)
        i64 = dict(dtype=torch.int64, device=org.device)
        out = (torch.empty(0, **f32), torch.empty(0, **i64),
               torch.empty(0, **f32), torch.empty(0, **f32),
               torch.empty(0, **i64))
        none = torch.empty(0, dtype=torch.int32, device=org.device)
        return out + (none, none) if want_counters else out
    return _launch_tris(bvh, org, direction, t_init, ignore_prim,
                        ignore_prim2, n, any_hit,
                        'union' if want_counters else 'persistent')


def simple_walk(bvh, org, direction, t_init, ignore_prim=None,
                ignore_prim2=None, any_hit=False, kind='tri', prim_offset=0):
    """The per-ray walk with its pops, thread i on ray i: (t, prim, u, v,
    slot, iters, leafs) with each ray's own inner and leaf pops [N] i32.
    CUDA tensors only.  kind 'tri' ('tri_counters'): the persistent
    launch's walk without the dealing, its yardstick, and the per-ray pops
    that bound it; kind 'line' ('line_counters'): the line policy's own
    walk (near-first order for closest-hit), ids global, from
    ``prim_offset`` as in ``closest_hit``.  Debug only: no render calls
    it."""
    n = _check_rays(org, direction, t_init, ignore_prim, ignore_prim2)
    if org.device.type != 'cuda' or n == 0:
        raise ValueError('simple_walk: needs rays on a CUDA device')
    if kind == 'line':
        _check_bvh(bvh, 'line', 'wide', org.device)
        return _launch('wide', 'line', org, direction, t_init, ignore_prim,
                       ignore_prim2, n, any_hit, bvh=bvh, want_counters=True,
                       prim_offset=prim_offset, key='line_counters')
    if kind != 'tri':
        raise ValueError(f'simple_walk: no counters launch for kind {kind!r}')
    _check_wide_tris(bvh, org.device)
    return _launch_tris(bvh, org, direction, t_init, ignore_prim, ignore_prim2,
                        n, any_hit, 'simple')


def occluded_tris(bvh, org, direction, t_init, ignore_prim=None,
                  ignore_prim2=None):
    """The any-hit launch that writes only its answer: blocked [N] bool,
    ``traverse_tris(..., any_hit=True)[1] >= 0`` without the other four
    outputs.  Counts as an 'any' launch."""
    n = _check_rays(org, direction, t_init, ignore_prim, ignore_prim2)
    _check_wide_tris(bvh, org.device)
    if org.device.type == 'cpu':
        return traverse_tris_plain(bvh.wbounds, bvh.wlinks, bvh.leaf_packed,
                                   org, direction, t_init, ignore_prim,
                                   ignore_prim2, any_hit=True)[1] >= 0
    if org.device.type != 'cuda':
        raise ValueError(f'traverse_tris: no kernel for {org.device}')
    if n == 0:
        return torch.empty(0, dtype=torch.bool, device=org.device)
    return _launch_tris(bvh, org, direction, t_init, ignore_prim, ignore_prim2,
                        n, True, blocked_only=True)


# --- the forms that replace XLA's skip-link _traverse ------------------------

def _form_of(target, kind):
    """'dense' for a tuple of list arrays, else 'wide' or, for a tree
    without a wide layout (too deep for the wide stack), 'deep' or, where
    upload gave it no deep records either (too deep for ``MAX_BIN_STACK``),
    'skip'."""
    if isinstance(target, (tuple, list)):
        return 'dense'
    if target.knodes is not None or target.wbounds is not None:
        return 'wide'
    return 'deep' if target.bnodes is not None else 'skip'


def _count_key(form, kind, any_hit):
    mode = 'any' if any_hit else 'closest'
    if (form, kind) == ('wide', 'tri'):   # the TPU kernel's specialisations
        return mode
    name = {'wide': kind, 'deep': 'deep', 'skip': 'skip',
            'dense': f'dense_{kind}'}[form]
    return f'{name}_{mode}'


def _wide_tris_plain(bvh, org, direction, t_init, ignore_prim, ignore_prim2,
                     carry, any_hit):
    """The static triangles of a wide tree by ``traverse_tris_plain`` (the
    TPU kernel's winner), from the running hit as the kernel takes it: a
    ray starts at the carried t (a blocked one does no work) and keeps its
    record unless the walk found a closer hit."""
    start = t_init
    if carry is not None:
        start = torch.where(carry, 0.0, _fresh_hit(
            org.shape[0], t_init, org.device)[0]) if any_hit else carry[0]
    out = traverse_tris_plain(bvh.wbounds, bvh.wlinks, bvh.leaf_packed, org,
                              direction, start, ignore_prim, ignore_prim2,
                              any_hit=any_hit)
    found = out[1] >= 0
    if any_hit:
        return found if carry is None else carry | found
    if carry is None:
        return out
    return tuple(torch.where(found, new, old) for new, old in zip(out, carry))


def _trace_plain(target, kind, org, direction, t_init, ignore_prim,
                 ignore_prim2, time, prim_offset, carry, any_hit,
                 want_counts=False):
    """What ``_trace`` computes, by the plain versions, on any device;
    ``carry`` is not modified.  want_counts (a tree or a dense line list):
    also the per-ray numbers of nodes visited, of leaves tested and of line
    rows missed at the discriminant (``trace_plain.walk_plain``; a dense
    list visits no node and tests no leaf)."""
    n, dev = org.shape[0], org.device
    if (_form_of(target, kind), kind) == ('wide', 'tri'):
        if want_counts:
            raise ValueError('traverse_tris: the pop counts of the static '
                             'wide walk come from traverse_tris')
        return _wide_tris_plain(target, org, direction, t_init, ignore_prim,
                                ignore_prim2, carry, any_hit)
    if any_hit:
        # the plain versions flag a blocked lane as prim >= 0
        hit = _fresh_hit(n, t_init, dev)
        if carry is not None:
            hit = (hit[0], torch.where(carry, 0, -1)) + hit[2:]
    else:
        hit = carry if carry is not None else _fresh_hit(n, t_init, dev)
    kw = dict(ignore_prim=ignore_prim, ignore_prim2=ignore_prim2, time=time,
              prim_offset=prim_offset, any_hit=any_hit)
    if _form_of(target, kind) == 'dense':
        out = trace_plain.dense_plain(kind, target, org, direction, *hit[:4],
                                      want_counts=want_counts, **kw)
        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        out = out[:4] + (hit[4],) + ((zero, zero) + out[4:] if want_counts
                                     else ())
    else:
        out = trace_plain.walk_plain(target, kind, org, direction, *hit,
                                     want_counts=want_counts, **kw)
    res = out[1] >= 0 if any_hit else out[:5]
    return (res,) + out[5:] if want_counts else res


def _trace(target, kind, org, direction, t_init, ignore_prim, ignore_prim2,
           time, prim_offset, carry, any_hit):
    """closest_hit and any_hit behind their argument checks."""
    dev = org.device
    n = _check_rays(org, direction, t_init, ignore_prim, ignore_prim2, time)
    form = _form_of(target, kind)
    if kind == 'moving' and time is None:
        raise ValueError('traverse_tris: moving triangles need ray times')
    if carry is not None:
        _check_carry(carry, any_hit, n, dev)
    if form == 'dense':
        _check_dense(kind, target, dev)
        where = dict(recs=target)
    else:
        _check_bvh(target, kind, form, dev)
        if (form, kind) == ('wide', 'tri'):
            _check_wide_tris(target, dev)
        where = dict(bvh=target)
    if dev.type == 'cpu':
        return _trace_plain(target, kind, org, direction, t_init, ignore_prim,
                            ignore_prim2, time, prim_offset, carry, any_hit)
    if dev.type != 'cuda':
        raise ValueError(f'traverse_tris: no kernel for {dev}')
    if n == 0:
        if carry is not None:
            return carry
        return (torch.empty(0, dtype=torch.bool, device=dev) if any_hit
                else _fresh_hit(0, t_init, dev))
    return _launch(form, kind, org, direction, t_init, ignore_prim,
                   ignore_prim2, n, any_hit, time=time,
                   prim_offset=prim_offset, carry=carry, blocked_only=any_hit,
                   key=_count_key(form, kind, any_hit), **where)


def closest_hit(target, kind, org, direction, t_init, ignore_prim=None,
                time=None, prim_offset=0, carry=None):
    """Closest hit of one prim kind, starting from the best hit so far.

    ``target``: a ``trace.DeviceBVH`` of the kind (walked wide, or by skip
    links if it has no wide layout), or the arrays of a dense list of at
    most ``DENSE_MAX`` prims (spheres: (c, r, c_t1 or None); lines: (v0,
    v1, r0, r1)), which every ray tests in full.  kind: 'tri', 'moving'
    (triangles lerped at the ray ``time`` [N]), 'sphere' or 'line'.
    ``prim_offset``: the global id of the kind's prim 0; ``ignore_prim``
    and the returned prim are global ids.  ``carry``: the running (t, prim,
    u, v, slot) of the call's earlier launches, updated where this kind is
    closer (on the card in place) and returned; without it the rays start
    at ``t_init`` as in ``traverse_tris``.  A sphere hit leaves u, v and
    slot as they were, a line hit sets u (the axial fraction).  The static
    triangles of a wide tree ('tri') are the TPU kernel's closest-hit
    specialisation, what ``traverse_tris`` launches, and count as such."""
    return _trace(target, kind, org, direction, t_init, ignore_prim, None,
                  time, prim_offset, carry, any_hit=False)


def closest_hit_plain(target, kind, org, direction, t_init, ignore_prim=None,
                      time=None, prim_offset=0, carry=None,
                      want_counts=False):
    """``closest_hit`` by the plain torch versions (``trace_plain``), on
    the CPU or on the card: what the CUDA forms are held against.
    want_counts (trees and dense line lists): returns (hit, visits, leafs,
    missed), the per-ray numbers of nodes visited, leaves tested and
    (lines) filled rows whose discriminant is not positive, by the
    skip-link walk (a dense list: 0 nodes and leaves, its lines)."""
    return _trace_plain(target, kind, org, direction, t_init, ignore_prim,
                        None, time, prim_offset, carry, False, want_counts)


def any_hit_plain(target, kind, org, direction, t_init, ignore_prim=None,
                  ignore_prim2=None, time=None, prim_offset=0, carry=None,
                  want_counts=False):
    """``any_hit`` by the plain torch versions."""
    return _trace_plain(target, kind, org, direction, t_init, ignore_prim,
                        ignore_prim2, time, prim_offset, carry, True,
                        want_counts)


def any_hit(target, kind, org, direction, t_init, ignore_prim=None,
            ignore_prim2=None, time=None, prim_offset=0, carry=None):
    """blocked [N] bool: a prim of the kind lies in (0, t_init).  Arguments
    as ``closest_hit``; ``carry``: the blocked flags of the call's earlier
    launches, whose set lanes do no work and stay set."""
    return _trace(target, kind, org, direction, t_init, ignore_prim,
                  ignore_prim2, time, prim_offset, carry, any_hit=True)


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


def _pick(x, row):
    """x [..., 8] at the leaf row ``row`` [...]."""
    return x.gather(-1, row[..., None]).squeeze(-1)


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
                        any_hit=False, want_counters=False, ray_pops=False):
    """The kernel's walk in vectorised torch: per-ray stacks
    [N, MAX_STACK] and a lockstep loop over the rays whose stack is not
    empty; each step pops one entry per ray.  It walks the reference arrays
    with the slab, Moeller-Trumbore and winner-encoding arithmetic of
    ``csrc/traverse_tris.cu`` and takes the argument forms of
    ``traverse_tris``.  want_counters: the TPU kernel's union walk
    instead, ``union_walk_plain``, whose counts are those of a 128-ray
    tile.  ray_pops: also each ray's own inner and leaf pops [N] int32,
    as ``simple_walk`` counts them."""
    if want_counters:
        return union_walk_plain(wbounds, wlinks, leaf_packed, org, direction,
                                t_init, ignore_prim, ignore_prim2,
                                any_hit=any_hit)
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
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    leafs = torch.zeros_like(iters)
    links = wlinks.to(torch.int64).reshape(-1, 8)
    weight = wbounds[:, :, 6]
    act = torch.nonzero(sp > 0)[:, 0]
    while act.numel():
        top = sp[act] - 1
        e = stack[act, top]
        sp[act] = top
        inner = e >= 0

        ai, ei = act[inner], e[inner]
        iters[ai] += 1
        if ai.numel():
            hitc = _slab_hits(wbounds[ei], org[ai][:, None, :],
                              inv[ai][:, None, :], t[ai][:, None])
            _push(stack, sp, ai, ei, hitc, links, weight)

        al, el = act[~inner], e[~inner]
        leafs[al] += 1
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
    return (t, prim, u, v, slot) + ((iters, leafs) if ray_pops else ())


def union_walk_plain(wbounds, wlinks, leaf_packed, org, direction, t_init,
                     ignore_prim=None, ignore_prim2=None, any_hit=False,
                     tile_stats=False):
    """The TPU kernel's union walk with ``want_counters``
    (trace_pallas.py:60-220), in vectorised torch: what ``union_kernel``
    computes.  The rays, padded to whole ``BLOCK``s with dead lanes
    (t_init 0, no ignore id), fall in tiles of ``TILE`` = 128.  A tile
    walks the union of its lanes' hits with one stack: an inner pop pushes
    a child (ascending child index) when any lane's slab test at its own
    running t hits it, a leaf pop tests every lane against every row.
    Any-hit sets a blocked lane's prim to 0 and its t to -1 and stops a
    tile once none of its 128 lanes is open (dead and padded lanes count
    as open); a tile without a live lane pops its root once.  Each tile
    has its own stack [MAX_STACK], and the loop runs in lockstep over the
    tiles still walking, one pop a tile a step.

    Returns (t, prim, u, v, slot) as ``traverse_tris`` does and (iters,
    leafs) [ceil(N/BLOCK)] int32, the inner and leaf pops of a block's 8
    tiles.  tile_stats: also, per tile [n_tiles] int64, its inner pops,
    its leaf pops, its live lanes (t_init > 0) and the sums over its inner
    and over its leaf pops of the lanes open at the pop (live and, under
    any-hit, not yet blocked): the lanes whose test a pop needs."""
    n, dev = org.shape[0], org.device
    n_pad = -(-n // BLOCK) * BLOCK
    n_tiles = n_pad // TILE
    inv, t, ig1, ig2 = _start(org, direction, t_init, ignore_prim,
                              ignore_prim2)
    pad = lambda x, fill: torch.cat(
        [x, x.new_full((n_pad - n,) + x.shape[1:], fill)])
    lane = lambda x, fill: pad(x, fill).reshape(n_tiles, TILE, *x.shape[1:])
    # padded lanes as the TPU kernel pads them: every input 0, ids -1
    o, d, iv = (lane(x, 0.0)[:, :, None] for x in (org, direction, inv))
    ig1, ig2 = lane(ig1, -1)[..., None], lane(ig2, -1)[..., None]
    t = lane(t, 0.0)
    live = (t > 0).sum(dim=1)
    prim = torch.full((n_tiles, TILE), -1, dtype=torch.int64, device=dev)
    slot = prim.clone()
    u = torch.zeros((n_tiles, TILE), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    stack = torch.zeros((n_tiles, MAX_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(n_tiles, dtype=torch.int64, device=dev)   # the root
    nopen = torch.full((n_tiles,), TILE, dtype=torch.int64, device=dev)
    iters = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    leafs = torch.zeros_like(iters)
    inner_lanes = torch.zeros_like(iters)
    leaf_lanes = torch.zeros_like(iters)
    links = wlinks.to(torch.int64).reshape(-1, 8)
    weight = wbounds[:, :, 6]
    act = torch.arange(n_tiles, device=dev)
    while act.numel():
        top = sp[act] - 1
        e = stack[act, top]
        sp[act] = top
        inner = e >= 0

        ai, ei = act[inner], e[inner]
        iters[ai] += 1
        if tile_stats:
            n_open = (t[act] > 0).sum(dim=1)
            inner_lanes[ai] += n_open[inner]
            leaf_lanes[act[~inner]] += n_open[~inner]
        if ai.numel():
            hitc = _slab_hits(wbounds[ei][:, None], o[ai], iv[ai],
                              t[ai][..., None])              # [k, 128, 8]
            _push(stack, sp, ai, ei, hitc.any(dim=1), links, weight)

        al, el = act[~inner], e[~inner]
        leafs[al] += 1
        if al.numel():
            lid = -el - 1
            ok, tt, bu, bv, cand = _tri_rows(
                leaf_packed[lid][:, None], o[al], d[al], t[al][..., None],
                ig1[al], ig2[al])                             # [k, 128, 8]
            if any_hit:
                blocked = ok.any(dim=2)
                prim[al] = torch.where(blocked, 0, prim[al])
                t[al] = torch.where(blocked, -1.0, t[al])
                nopen[al] = (prim[al] < 0).sum(dim=1)
            else:
                win, k = _winner(ok, tt)
                keep = lambda new, old: torch.where(win, new, old)
                t[al] = keep(_pick(tt, k), t[al])
                u[al] = keep(_pick(bu, k), u[al])
                v[al] = keep(_pick(bv, k), v[al])
                prim[al] = keep(_pick(cand, k).to(torch.int64), prim[al])
                slot[al] = keep(lid[:, None] * LEAF + k, slot[al])
        go = sp[act] > 0
        if any_hit:
            go &= nopen[act] > 0
        act = act[go]
    per_block = lambda x: x.reshape(-1, BLOCK // TILE).sum(dim=1).to(
        torch.int32)
    out = tuple(x.reshape(-1)[:n] for x in (t, prim, u, v, slot)) + (
        per_block(iters), per_block(leafs))
    stats = (iters, leafs, live, inner_lanes, leaf_lanes)
    return out + stats if tile_stats else out
