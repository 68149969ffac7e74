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
the minimum of ``(bits(t) & ~7) | k``, ``-fmad=false``.  The counters
launches keep the simple assignment (thread i walks ray i) and share the
rest.  The line policy's closest-hit walk is near-first instead (children
sorted by entry distance, an entry the running t has passed dropped at
its pop; an exact-t tie between two fibres may then go to another fibre
than the plain walk's), and its records carry each fibre's own terms of
the cone test (``pack_line_rows``), which the plain walk reads as well.

Build: ``nvcc`` compiles ``csrc/traverse_tris.cu`` (plain C interface)
for sm_90a into ``_build/`` and ``ctypes`` loads it; the launch's
``cudaGetLastError`` comes back as the C function's result and raises.
On a CPU tensor the wrappers run ``traverse_tris_plain``; on a CUDA
tensor they launch the kernel or raise.  ``launches`` counts kernel
launches per specialisation ('closest', 'any', and 'counters' for the
launches with ``want_counters``, either hit mode) and per further form.

Further forms (``closest_hit``, ``any_hit``).  What the JAX package
serves with XLA's lockstep skip-link ``_traverse`` and its dense
small-list branches, not with Pallas, runs here as more forms of the same
source file, because a lockstep torch loop would wait on the host at every
step: the wide walk with a moving-triangle, a sphere or a cone (line) leaf
policy ('moving', 'sphere', 'line'), a stackless skip-link walk over
``DeviceBVH.nodes`` for a tree too deep for ``MAX_STACK`` ('deep'), and
the dense test of a list of at most ``DENSE_MAX`` spheres or lines
('dense_sphere', 'dense_line'), which reads the geometry's own arrays and
is the only form that lerps sphere centres in time.  Their winner is
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

Counters, per-ray walk against the TPU's union walk: the TPU kernel counts
the pops of a 128-ray tile walking the union of its rays' hits, the port
counts each ray's own pops and sums them per ``BLOCK`` = 1024 rays.  With
one live ray per tile both walks pop the same nodes in the same order, so
closest-hit totals are equal per block; with many live rays the per-ray
sum is at least the union count.  Any-hit differs even with one live ray:
the TPU loop stops early only when all 128 lanes are blocked (dead lanes
count as open, trace_pallas.py:159,188-193), so a blocked ray's tile keeps
popping there and the port's count is lower.  A tile with no live ray pops
its root once on the TPU and nothing here.
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
K_MASK = 7       # low mantissa bits that carry the winning leaf row
NO_HIT = 0x7f000000
BLOCK = 1024     # rays per counter block (the TPU kernel's grid step)
LEAF_ROW = 12    # floats per triangle leaf row in the kernel layout
DENSE_MAX = 64   # prims a dense list can hold (trace.BRUTE_FORCE_MAX)
# floats per leaf row of each kind's kernel records (float4 multiples)
ROW_FLOATS = {'tri': 12, 'moving': 12, 'sphere': 8, 'line': 12}
_FORMS = {'wide': 0, 'deep': 1, 'dense': 2}
_KINDS = {'tri': 0, 'moving': 1, 'sphere': 2, 'line': 3}

# kernel launches per form: the TPU kernel's three specialisations
# ('closest', 'any', 'counters': static triangles, wide walk), then the
# forms that replace XLA's _traverse, each closest-hit and any-hit: the
# wide walk with the moving-triangle, sphere and line policies, the
# deep-tree walk (any policy) and the dense sphere and line lists; and the
# line policy's counters launch ('line_counters', simple_walk)
launches = {k: 0 for k in (
    'closest', 'any', 'counters',
    *(f'{f}_{m}' for f in ('moving', 'sphere', 'line', 'deep', 'dense_sphere',
                           'dense_line') for m in ('closest', 'any')),
    'line_counters')}

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
        ('nodes', _p), ('leaves', _p), ('leaves_t1', _p), ('depth', _i),
        ('n_nodes', _i), ('d0', _p), ('d1', _p), ('d2', _p), ('d3', _p),
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


def pack_nodes(wbounds: np.ndarray, wlinks: np.ndarray) -> np.ndarray:
    """knodes [Wn, 8, 8] f32: per child min3, max3, push weight, and the
    child's link as int32 bits in the reference pad word: one
    16-byte-aligned 256 B record a node, read as 16 float4."""
    knodes = np.ascontiguousarray(wbounds, np.float32).copy()
    knodes[:, :, 7] = np.ascontiguousarray(
        wlinks, np.int32).reshape(-1, 8).view(np.float32)
    return knodes


def pack_leaf_rows(kind: str, leaf_data: np.ndarray,
                   leaf_prims: np.ndarray) -> np.ndarray:
    """One kind's leaf-slot-major rows [slots, D] and local prim ids
    [slots] (-1: padding) -> the kernel's records [n_leaves, 8, ROW], the
    id as int32 bits, every row a whole number of float4:

    'tri' (and each shutter time of 'moving'), D = 9:
        v0.xyz, id | e1.xyz, 0 | e2.xyz, 0
    'sphere', D = 4:  c.xyz, r | id, 0, 0, 0
    Lines have their own records (``pack_line_rows``)."""
    d = np.ascontiguousarray(leaf_data, np.float32)
    ids = np.ascontiguousarray(leaf_prims).astype(np.int32).view(np.float32)
    rows = np.zeros((d.shape[0], ROW_FLOATS[kind]), np.float32)
    if kind in ('tri', 'moving'):
        rows[:, 0:3], rows[:, 3] = d[:, 0:3], ids
        rows[:, 4:7], rows[:, 8:11] = d[:, 3:6], d[:, 6:9]
    elif kind == 'sphere':
        rows[:, 0:4], rows[:, 4] = d[:, 0:4], ids
    else:
        raise ValueError(f'pack_leaf_rows: no rows of kind {kind!r} here')
    return rows.reshape(-1, LEAF, ROW_FLOATS[kind])


def line_rows(v0, ids, axis, r0, length, k, kk, filled):
    """The kernel's line records [n_leaves, 8, 12] from their fields, one
    entry a leaf slot: v0 [S, 3], ids [S] int32 (-1: padding), the unit
    axis [S, 3], r0, length, k, k*k [S] f32 and the filled rows of the
    slot's leaf [S] int32:
        v0.xyz, id | axis.xyz, r0 | length, k, k*k, filled rows
    (ints as their bits).  The inverse of ``unpack_line_rows``."""
    col = lambda x: x.reshape(-1, 1)
    rows = torch.cat([v0, col(ids.view(torch.float32)), axis, col(r0),
                      col(length), col(k), col(kk),
                      col(filled.view(torch.float32))], dim=1)
    return rows.reshape(-1, LEAF, ROW_FLOATS['line'])


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
    if len(recs) != (3 if kind == 'sphere' else 4):
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
        want = [('line_v0', recs[0], f32, (k, 3)),
                ('line_v1', recs[1], f32, (k, 3)),
                ('line_r0', recs[2], f32, (k,)), ('line_r1', recs[3], f32, (k,))]
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
        want.append(('kleaves_t1', bvh.kleaves_t1, f32, shape))
    if form == 'wide':
        kn = bvh.knodes
        if not isinstance(kn, torch.Tensor) or kn.dim() != 3:
            raise ValueError('traverse_tris: the BVH carries no kernel '
                             'layout for this device (knodes)')
        want.append(('knodes', kn, f32, (kn.shape[0], 8, 8)))
        if not 1 <= bvh.stack_depth <= MAX_STACK:
            raise ValueError(f'traverse_tris: stack depth {bvh.stack_depth}')
    else:
        want.append(('nodes', bvh.nodes, f32, (bvh.nodes.shape[0], 8)))
    try:
        _check_tensors(want, dev)
    except (TypeError, ValueError) as e:
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         f'for this device ({e})') from None


def block_sums(per_ray: torch.Tensor) -> torch.Tensor:
    """Per-ray int counts [N] -> sums per BLOCK rays [ceil(N/BLOCK)] int32,
    the last block padded with rays that count 0."""
    pad = (-per_ray.shape[0]) % BLOCK
    padded = torch.nn.functional.pad(per_ray.to(torch.int64), (0, pad))
    return padded.reshape(-1, BLOCK).sum(dim=1).to(torch.int32)


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
    slot) plus per-ray (iters, leafs) with want_counters.  With ``carry``
    (the running hit, or the blocked flags) the launch updates those
    tensors in place and returns them.  ``key``: the entry of ``launches``
    that counts it."""
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
    if want_counters:
        iters = torch.empty(n, dtype=torch.int32, device=dev)
        leafs = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form == 'wide' and not want_counters:
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
        a.d0, a.d1, a.d2 = ptr(recs[0]), ptr(recs[1]), ptr(recs[2])
        a.d3 = ptr(recs[3]) if len(recs) > 3 else None
    else:
        a.leaves = bvh.kleaves.data_ptr()
        a.leaves_t1 = ptr(bvh.kleaves_t1) if kind == 'moving' else None
        if form == 'wide':
            a.nodes, a.depth = bvh.knodes.data_ptr(), bvh.stack_depth
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
                 any_hit, want_counters, blocked_only):
    """The TPU kernel's specialisations: static triangles, wide walk."""
    _check_bvh(bvh, 'tri', 'wide', org.device)
    if tuple(bvh.knodes.shape) != tuple(bvh.wbounds.shape) or \
            bvh.kleaves.shape[0] != bvh.leaf_packed.shape[0]:
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         'for this device (knodes, kleaves)')
    return _launch('wide', 'tri', org, direction, t_init, ignore_prim,
                   ignore_prim2, n, any_hit, bvh=bvh,
                   want_counters=want_counters, blocked_only=blocked_only,
                   key='counters' if want_counters
                   else 'any' if any_hit else 'closest')


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
    want_counters appends (iters, leafs) [ceil(N/BLOCK)] i32: inner-node
    and leaf pops per 1024-ray block (see the module docstring)."""
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
    out = _launch_tris(bvh, org, direction, t_init, ignore_prim, ignore_prim2,
                       n, any_hit, want_counters, blocked_only=False)
    if want_counters:
        return out[:5] + (block_sums(out[5]), block_sums(out[6]))
    return out


def simple_walk(bvh, org, direction, t_init, ignore_prim=None,
                ignore_prim2=None, any_hit=False, kind='tri', prim_offset=0):
    """The counters launch as it comes from the card: (t, prim, u, v, slot,
    iters, leafs) with per-ray pop counts [N] i32, not summed per block.
    CUDA tensors only.  kind 'tri': the yardstick the persistent launch is
    timed against; kind 'line': the line policy's own walk (near-first
    order for closest-hit), its inner and leaf pops a ray, counted as
    'line_counters' (ids global, from ``prim_offset`` as in
    ``closest_hit``).  Debug only: no render calls it."""
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
                        n, any_hit, True, blocked_only=False)


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
                        n, True, False, blocked_only=True)


# --- the forms that replace XLA's skip-link _traverse ------------------------

def _form_of(target, kind):
    """'dense' for a tuple of list arrays, else 'wide' or, for a tree
    without a wide layout (too deep for the stack), 'deep'."""
    if isinstance(target, (tuple, list)):
        return 'dense'
    return 'wide' if target.knodes is not None or target.wbounds is not None \
        else 'deep'


def _count_key(form, kind, any_hit):
    mode = 'any' if any_hit else 'closest'
    if (form, kind) == ('wide', 'tri'):   # the TPU kernel's specialisations
        return mode
    name = {'wide': kind, 'deep': 'deep', 'dense': f'dense_{kind}'}[form]
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
    ``carry`` is not modified.  want_counts (a tree, not a dense list):
    also the per-ray numbers of nodes visited, of leaves tested and of line
    rows missed at the discriminant (``trace_plain.walk_plain``)."""
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
                                      **kw) + (hit[4],)
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
    want_counts (trees only): returns (hit, visits, leafs, missed), the
    per-ray numbers of nodes visited, leaves tested and (lines) filled rows
    whose discriminant is not positive, by the skip-link walk."""
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


def traverse_tris_plain(wbounds, wlinks, leaf_packed, org, direction,
                        t_init, ignore_prim=None, ignore_prim2=None,
                        any_hit=False, want_counters=False):
    """The kernel's walk in vectorised torch: per-ray stacks
    [N, MAX_STACK] and a lockstep loop over the rays whose stack is not
    empty; each step pops one entry per ray.  It walks the reference arrays
    with the slab, Moeller-Trumbore and winner-encoding arithmetic of
    ``csrc/traverse_tris.cu``, takes the argument forms of
    ``traverse_tris`` and gives the same per-ray pop counts (summed per
    block) for want_counters."""
    n = org.shape[0]
    dev = org.device
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ignore_prim = none if ignore_prim is None else ignore_prim
    ignore_prim2 = none if ignore_prim2 is None else ignore_prim2
    inv = inv_dir(direction)
    if isinstance(t_init, torch.Tensor):
        t = t_init.clone()
    else:
        t = torch.full((n,), float(t_init), dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    iters = torch.zeros(n, dtype=torch.int64, device=dev)
    leafs = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev)
    sp = (t > 0).to(torch.int64)           # root (wide node 0) pushed
    links = wlinks.to(torch.int64).reshape(-1, 8)
    weight = wbounds[:, :, 6]
    karange = torch.arange(LEAF, dtype=torch.int32, device=dev)
    act = torch.nonzero(sp > 0)[:, 0]
    while act.numel():
        top = sp[act] - 1
        e = stack[act, top]
        sp[act] = top
        inner = e >= 0

        ai, ei = act[inner], e[inner]
        iters[ai] += 1
        if ai.numel():
            blk = wbounds[ei]                                   # [k, 8, 8]
            o, iv = org[ai][:, None, :], inv[ai][:, None, :]
            t0 = (blk[:, :, 0:3] - o) * iv
            t1 = (blk[:, :, 3:6] - o) * iv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                               torch.clamp(lo[..., 2], min=0.0))
            tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                               torch.minimum(hi[..., 2], t[ai][:, None]))
            w = weight[ei]
            hitc = (tn <= tf) & (tf > 0.0) & (w != 0.0)         # [k, 8]
            lk = links[ei]
            val = torch.where(w >= 256.0, -lk - 1, lk)
            hi_i = hitc.to(torch.int64)
            pos = sp[ai][:, None] + torch.cumsum(hi_i, dim=1) - hi_i
            rows = ai[:, None].expand(-1, 8)
            stack[rows[hitc], pos[hitc]] = val[hitc]
            sp[ai] += hi_i.sum(dim=1)

        al, el = act[~inner], e[~inner]
        leafs[al] += 1
        if al.numel():
            lid = -el - 1
            r = leaf_packed[lid]                                # [k, 8, 16]
            v0x, v0y, v0z = r[..., 0], r[..., 1], r[..., 2]
            e1x, e1y, e1z = r[..., 3], r[..., 4], r[..., 5]
            e2x, e2y, e2z = r[..., 6], r[..., 7], r[..., 8]
            cand = r[..., 9].to(torch.int32)
            ox, oy, oz = (org[al, c][:, None] for c in range(3))
            dx, dy, dz = (direction[al, c][:, None] for c in range(3))
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
            ok = ((bv >= 0.0) & (bv <= 1.0) & (bu >= 0.0)
                  & (bu + bv <= 1.0) & (tt > 0.0) & (tt < t[al][:, None])
                  & (cand >= 0) & (cand != ignore_prim[al][:, None])
                  & (cand != ignore_prim2[al][:, None]))
            if any_hit:
                b = al[ok.any(dim=1)]
                prim[b] = 0
                t[b] = -1.0
                sp[b] = 0
            else:
                enc = torch.where(ok, (tt.view(torch.int32) & ~K_MASK) | karange,
                                  NO_HIT)
                best = enc.amin(dim=1)
                win = best < NO_HIT
                wr = torch.nonzero(win)[:, 0]
                k = (best[wr] & K_MASK).to(torch.int64)
                dst = al[wr]
                t[dst] = tt[wr, k]
                u[dst] = bu[wr, k]
                v[dst] = bv[wr, k]
                prim[dst] = cand[wr, k].to(torch.int64)
                slot[dst] = lid[wr] * LEAF + k
        act = act[sp[act] > 0]
    if want_counters:
        return t, prim, u, v, slot, block_sums(iters), block_sums(leafs)
    return t, prim, u, v, slot
