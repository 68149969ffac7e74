"""BVH8 triangle traversal: the CUDA kernel's wrapper and its plain version.

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
rest.

Build: ``nvcc`` compiles ``csrc/traverse_tris.cu`` (plain C interface)
for sm_90a into ``_build/`` and ``ctypes`` loads it; the launch's
``cudaGetLastError`` comes back as the C function's result and raises.
On a CPU tensor the wrappers run ``traverse_tris_plain``; on a CUDA
tensor they launch the kernel or raise.  ``launches`` counts kernel
launches per specialisation ('closest', 'any', and 'counters' for the
launches with ``want_counters``, either hit mode).

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

from .bvh import LEAF_SIZE as LEAF

MAX_STACK = 192  # stack entries a thread can have: 96 KB of shared memory
K_MASK = 7       # low mantissa bits that carry the winning leaf row
NO_HIT = 0x7f000000
BLOCK = 1024     # rays per counter block (the TPU kernel's grid step)
LEAF_ROW = 12    # floats per leaf row in the kernel layout (3 float4)

launches = {'closest': 0, 'any': 0, 'counters': 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
_BUILD = os.path.join(os.path.dirname(_CSRC), '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')
_fn = None       # the loaded library's entry point
_work = {}       # (device, stream) -> the persistent launches' int32[2]
build_log = ''   # nvcc's report (registers, spills) on the library in use


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
    lib = ctypes.CDLL(lib_path)
    fn = lib.corona13_traverse_tris
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, ctypes.c_float, p, p, i, i,
                   p, p, p, p, p, p, p, p, p, i, p]
    fn.restype = i
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


def pack_kernel_layout(wbounds: np.ndarray, wlinks: np.ndarray,
                       leaf_packed: np.ndarray):
    """collapse8's arrays -> the kernel's records (numpy, at upload).

    knodes  [Wn, 8, 8] f32: per child min3, max3, push weight, and the
            child's link as int32 bits in the reference pad word: one
            16-byte-aligned 256 B record a node, read as 16 float4;
    kleaves [n_leaves, 8, 12] f32: per row v0.xyz, prim id as int32 bits |
            e1.xyz, 0 | e2.xyz, 0: 3 float4."""
    knodes = np.ascontiguousarray(wbounds, np.float32).copy()
    knodes[:, :, 7] = np.ascontiguousarray(
        wlinks, np.int32).reshape(-1, 8).view(np.float32)
    n_leaves = leaf_packed.shape[0]
    kleaves = np.zeros((n_leaves, LEAF, LEAF_ROW), np.float32)
    kleaves[:, :, 0:3] = leaf_packed[:, :, 0:3]
    kleaves[:, :, 3] = leaf_packed[:, :, 9].astype(np.int32).view(np.float32)
    kleaves[:, :, 4:7] = leaf_packed[:, :, 3:6]
    kleaves[:, :, 8:11] = leaf_packed[:, :, 6:9]
    return knodes, kleaves


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


def inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1/direction with components clamped away from 0 at +-1e-20 (the
    plain version's; the kernel computes the same bits itself)."""
    return 1.0 / torch.where(torch.abs(direction) < 1e-20,
                             torch.where(direction < 0, -1e-20, 1e-20),
                             direction)


def _check_rays(bvh, org, direction, t_init, ignore_prim, ignore_prim2):
    """Raise on what the kernel does not take; returns the ray count."""
    if org.dim() != 2 or org.shape[1] != 3:
        raise ValueError(f'traverse_tris: org has shape {tuple(org.shape)}, '
                         'needs (N, 3)')
    n = org.shape[0]
    int_ids = (torch.int32, torch.int64)
    want = [('wbounds', bvh.wbounds, (torch.float32,), None),
            ('wlinks', bvh.wlinks, (torch.int32,), None),
            ('leaf_packed', bvh.leaf_packed, (torch.float32,), None),
            ('org', org, (torch.float32,), (n, 3)),
            ('direction', direction, (torch.float32,), (n, 3))]
    if isinstance(t_init, torch.Tensor):
        want.append(('t_init', t_init, (torch.float32,), (n,)))
    if ignore_prim is not None:
        want.append(('ignore_prim', ignore_prim, int_ids, (n,)))
    if ignore_prim2 is not None:
        want.append(('ignore_prim2', ignore_prim2, int_ids, (n,)))
    for name, x, dtypes, shape in want:
        if x.device != org.device:
            raise ValueError(f'traverse_tris: {name} on {x.device}, '
                             f'rays on {org.device}')
        if x.dtype not in dtypes:
            raise TypeError(f'traverse_tris: {name} is {x.dtype}, '
                            f'needs {" or ".join(map(str, dtypes))}')
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f'traverse_tris: {name} has shape '
                             f'{tuple(x.shape)}, needs {shape}')
        if not x.is_contiguous():
            raise ValueError(f'traverse_tris: {name} is not contiguous')
    if (ignore_prim is not None and ignore_prim2 is not None
            and ignore_prim.dtype != ignore_prim2.dtype):
        raise TypeError('traverse_tris: ignore_prim and ignore_prim2 differ '
                        'in dtype')
    wb, wl, lp = bvh.wbounds, bvh.wlinks, bvh.leaf_packed
    if wb.dim() != 3 or tuple(wb.shape[1:]) != (8, 8):
        raise ValueError(f'traverse_tris: wbounds shape {tuple(wb.shape)}')
    if tuple(wl.shape) != (wb.shape[0] * 8,):
        raise ValueError(f'traverse_tris: wlinks shape {tuple(wl.shape)}')
    if lp.dim() != 3 or tuple(lp.shape[1:]) != (LEAF, 16):
        raise ValueError(f'traverse_tris: leaf_packed shape {tuple(lp.shape)}')
    return n


def block_sums(per_ray: torch.Tensor) -> torch.Tensor:
    """Per-ray int counts [N] -> sums per BLOCK rays [ceil(N/BLOCK)] int32,
    the last block padded with rays that count 0."""
    pad = (-per_ray.shape[0]) % BLOCK
    padded = torch.nn.functional.pad(per_ray.to(torch.int64), (0, pad))
    return padded.reshape(-1, BLOCK).sum(dim=1).to(torch.int32)


def _launch(bvh, org, direction, t_init, ignore_prim, ignore_prim2, n,
            any_hit, want_counters, blocked_only):
    """Launch the kernel on CUDA tensors already checked; returns the raw
    outputs: ``blocked`` (bool) if blocked_only, else (t, prim, u, v, slot)
    plus per-ray (iters, leafs) with want_counters."""
    dev = org.device
    kn, kl = bvh.knodes, bvh.kleaves
    if (kn is None or kl is None or kn.device != dev or kl.device != dev
            or kn.dtype != torch.float32 or kl.dtype != torch.float32
            or tuple(kn.shape) != tuple(bvh.wbounds.shape)
            or tuple(kl.shape) != (bvh.leaf_packed.shape[0], LEAF, LEAF_ROW)
            or not kn.is_contiguous() or not kl.is_contiguous()):
        raise ValueError('traverse_tris: the BVH carries no kernel layout '
                         'for this device (knodes, kleaves)')
    if not 1 <= bvh.stack_depth <= MAX_STACK:
        raise ValueError(f'traverse_tris: stack depth {bvh.stack_depth}')
    if n >= 1 << 30:
        raise ValueError(f'traverse_tris: {n} rays in one launch')
    fn = build()
    ptr = lambda x: None if x is None else x.data_ptr()
    f32 = dict(dtype=torch.float32, device=dev)
    t_tensor = t_init if isinstance(t_init, torch.Tensor) else None
    ids = ignore_prim if ignore_prim is not None else ignore_prim2
    is64 = int(ids is not None and ids.dtype == torch.int64)
    t = prim = u = v = slot = blocked = iters = leafs = work = None
    if blocked_only:
        blocked = torch.empty(n, dtype=torch.bool, device=dev)
    else:
        t, u, v = (torch.empty(n, **f32) for _ in range(3))
        prim = torch.empty(n, dtype=torch.int64, device=dev)
        slot = torch.empty(n, dtype=torch.int64, device=dev)
    if want_counters:
        iters = torch.empty(n, dtype=torch.int32, device=dev)
        leafs = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not want_counters:
        # the persistent launch's work counters: zeroed once here, left at
        # zero again by every launch, so launches of one stream share them
        work = _work.get((dev, stream))
        if work is None:
            work = _work[(dev, stream)] = torch.zeros(
                2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(kn.data_ptr(), kl.data_ptr(), bvh.stack_depth,
                 org.data_ptr(), direction.data_ptr(), ptr(t_tensor),
                 0.0 if t_tensor is not None else float(t_init),
                 ptr(ignore_prim), ptr(ignore_prim2), is64, n, ptr(t),
                 ptr(prim), ptr(u), ptr(v), ptr(slot),
                 ptr(blocked), ptr(iters), ptr(leafs), ptr(work),
                 int(bool(any_hit)), stream)
    if err != 0:
        raise RuntimeError(f'traverse_tris: the kernel launch failed with '
                           f'CUDA error {err}')
    launches['counters' if want_counters
             else 'any' if any_hit else 'closest'] += 1
    if blocked_only:
        return blocked
    if want_counters:
        return t, prim, u, v, slot, iters, leafs
    return t, prim, u, v, slot


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
    n = _check_rays(bvh, org, direction, t_init, ignore_prim, ignore_prim2)
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
    out = _launch(bvh, org, direction, t_init, ignore_prim, ignore_prim2, n,
                  any_hit, want_counters, blocked_only=False)
    if want_counters:
        return out[:5] + (block_sums(out[5]), block_sums(out[6]))
    return out


def simple_walk(bvh, org, direction, t_init, ignore_prim=None,
                ignore_prim2=None, any_hit=False):
    """The counters launch as it comes from the card: (t, prim, u, v, slot,
    iters, leafs) with per-ray pop counts [N] i32, not summed per block.
    CUDA tensors only; the yardstick the persistent launch is timed
    against."""
    n = _check_rays(bvh, org, direction, t_init, ignore_prim, ignore_prim2)
    if org.device.type != 'cuda' or n == 0:
        raise ValueError('simple_walk: needs rays on a CUDA device')
    return _launch(bvh, org, direction, t_init, ignore_prim, ignore_prim2, n,
                   any_hit, True, blocked_only=False)


def occluded_tris(bvh, org, direction, t_init, ignore_prim=None,
                  ignore_prim2=None):
    """The any-hit launch that writes only its answer: blocked [N] bool,
    ``traverse_tris(..., any_hit=True)[1] >= 0`` without the other four
    outputs.  Counts as an 'any' launch."""
    n = _check_rays(bvh, org, direction, t_init, ignore_prim, ignore_prim2)
    if org.device.type == 'cpu':
        return traverse_tris_plain(bvh.wbounds, bvh.wlinks, bvh.leaf_packed,
                                   org, direction, t_init, ignore_prim,
                                   ignore_prim2, any_hit=True)[1] >= 0
    if org.device.type != 'cuda':
        raise ValueError(f'traverse_tris: no kernel for {org.device}')
    if n == 0:
        return torch.empty(0, dtype=torch.bool, device=org.device)
    return _launch(bvh, org, direction, t_init, ignore_prim, ignore_prim2, n,
                   True, False, blocked_only=True)


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
