"""BVH8 triangle traversal: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``corona13_tpu/ops/trace_pallas.py``
(``_kernel`` behind ``traverse_tris``), the only ``pallas_call`` of the
JAX package.  Both specialisations are ported: closest-hit (``intersect``)
and any-hit (``occluded``, the NEE shadow ray).  They walk the same
``collapse8`` arrays (``corona13_tpu/ops/bvh.py``): ``wbounds [Wn,8,8]``
child boxes plus push weights, ``wlinks [Wn*8]`` child links and
``leaf_packed [n_leaves,8,16]`` rows (v0, e1, e2, prim as f32).

Kernel design (``csrc/traverse_tris.cu``): one thread per ray with a
private int32 stack of ``MAX_STACK`` entries.  An inner pop slab-tests the
8 children with the TPU kernel's exact expressions and pushes the hit
ones in ascending child order (a leaf as ``-link-1``); a leaf pop runs
Moeller-Trumbore on its 8 rows and picks the winner by the TPU kernel's
encoding, the minimum of ``(bits(t) & ~7) | k``, so near-ties go to the
lower row exactly as there.  The visit order is the TPU kernel's packet
order restricted to the ray's own hits.

What bounds it on the H100: divergent, latency-bound gathers of 256 B
node rows and 512 B leaf rows per step, and the stack in local memory;
there is no matrix work.  Warp-level packets, TMA staging of the top
levels, ``wgmma`` and stackless schemes are later work.

On a CPU tensor ``traverse_tris`` runs ``traverse_tris_plain``, a
vectorised torch version of the same walk over the same arrays; on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches per specialisation.
"""

from __future__ import annotations

import os

import torch

from .bvh import LEAF_SIZE as LEAF

MAX_STACK = 192  # >= wdepth*7 + 8, enforced by trace.DeviceBVH.from_host
K_MASK = 7       # low mantissa bits that carry the winning leaf row
NO_HIT = 0x7f000000

launches = {'closest': 0, 'any': 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
_BUILD = os.path.join(os.path.dirname(_CSRC), '_build')
_ext = None


def build(verbose: bool = False):
    """Compile (once per process) and load the CUDA extension from
    ``csrc/`` into ``_build/`` for sm_90a."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load
        os.makedirs(_BUILD, exist_ok=True)   # load() does not create it
        _ext = load(
            name='corona13_traverse',
            sources=[os.path.join(_CSRC, 'bind.cpp'),
                     os.path.join(_CSRC, 'traverse_tris.cu')],
            build_directory=_BUILD,
            extra_cflags=['-O2'],
            extra_cuda_cflags=['-O3', '-gencode=arch=compute_90a,code=sm_90a',
                               '-fmad=false'],
            verbose=verbose)
    return _ext


def inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1/direction with components clamped away from 0 at +-1e-20."""
    return 1.0 / torch.where(torch.abs(direction) < 1e-20,
                             torch.where(direction < 0, -1e-20, 1e-20),
                             direction)


def _check(wbounds, wlinks, leaf_packed, org, direction, t_init,
           ignore_prim, ignore_prim2):
    n = org.shape[0]
    want = [('wbounds', wbounds, torch.float32, None),
            ('wlinks', wlinks, torch.int32, None),
            ('leaf_packed', leaf_packed, torch.float32, None),
            ('org', org, torch.float32, (n, 3)),
            ('direction', direction, torch.float32, (n, 3)),
            ('t_init', t_init, torch.float32, (n,)),
            ('ignore_prim', ignore_prim, torch.int32, (n,)),
            ('ignore_prim2', ignore_prim2, torch.int32, (n,))]
    for name, x, dtype, shape in want:
        if x.device != org.device:
            raise ValueError(f'traverse_tris: {name} on {x.device}, '
                             f'rays on {org.device}')
        if x.dtype != dtype:
            raise TypeError(f'traverse_tris: {name} is {x.dtype}, '
                            f'needs {dtype}')
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f'traverse_tris: {name} has shape '
                             f'{tuple(x.shape)}, needs {shape}')
        if not x.is_contiguous():
            raise ValueError(f'traverse_tris: {name} is not contiguous')
    if wbounds.dim() != 3 or tuple(wbounds.shape[1:]) != (8, 8):
        raise ValueError(f'traverse_tris: wbounds shape {tuple(wbounds.shape)}')
    if tuple(wlinks.shape) != (wbounds.shape[0] * 8,):
        raise ValueError(f'traverse_tris: wlinks shape {tuple(wlinks.shape)}')
    if leaf_packed.dim() != 3 or tuple(leaf_packed.shape[1:]) != (LEAF, 16):
        raise ValueError(
            f'traverse_tris: leaf_packed shape {tuple(leaf_packed.shape)}')


def traverse_tris(wbounds, wlinks, leaf_packed, org, direction, t_init,
                  ignore_prim, ignore_prim2=None, any_hit=False):
    """Closest-hit (or any-hit) triangle traversal for a ray wavefront.

    org/direction [N, 3] f32; t_init [N] f32 (exclusive upper bound; lanes
    with t_init <= 0 do no work); ignore_prim(2) [N] i32.  Returns
    (t, prim, u, v, slot): prim/slot i32, prim = -1 for misses,
    slot = leaf_id*8 + row.  any_hit: prim = 0 on blocked lanes."""
    if ignore_prim2 is None:
        ignore_prim2 = torch.full_like(ignore_prim, -1)
    _check(wbounds, wlinks, leaf_packed, org, direction, t_init,
           ignore_prim, ignore_prim2)
    if org.device.type == 'cpu':
        return traverse_tris_plain(wbounds, wlinks, leaf_packed, org,
                                   direction, t_init, ignore_prim,
                                   ignore_prim2, any_hit=any_hit)
    if org.device.type != 'cuda':
        raise ValueError(f'traverse_tris: no kernel for {org.device}')
    n = org.shape[0]
    f32 = dict(dtype=torch.float32, device=org.device)
    i32 = dict(dtype=torch.int32, device=org.device)
    if n == 0:
        return (torch.empty(0, **f32), torch.empty(0, **i32),
                torch.empty(0, **f32), torch.empty(0, **f32),
                torch.empty(0, **i32))
    inv = inv_dir(direction)
    t, prim, u, v, slot = build().traverse_tris(
        wbounds, wlinks, leaf_packed, org, direction, inv, t_init,
        ignore_prim, ignore_prim2, bool(any_hit))
    launches['any' if any_hit else 'closest'] += 1
    return t, prim, u, v, slot


def traverse_tris_plain(wbounds, wlinks, leaf_packed, org, direction,
                        t_init, ignore_prim, ignore_prim2=None,
                        any_hit=False):
    """The kernel's walk in vectorised torch: per-ray stacks
    [N, MAX_STACK] and a lockstep loop over the rays whose stack is not
    empty; each step pops one entry per ray.  Same slab, Moeller-Trumbore
    and winner-encoding arithmetic as ``csrc/traverse_tris.cu``."""
    n = org.shape[0]
    dev = org.device
    if ignore_prim2 is None:
        ignore_prim2 = torch.full_like(ignore_prim, -1)
    inv = inv_dir(direction)
    t = t_init.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev)
    sp = (t_init > 0).to(torch.int64)      # root (wide node 0) pushed
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
                prim[dst] = cand[wr, k]
                slot[dst] = (lid[wr] * LEAF + k).to(torch.int32)
        act = act[sp[act] > 0]
    return t, prim, u, v, slot
