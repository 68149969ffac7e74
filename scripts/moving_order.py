"""The wide walk's orders against the reference's, on the CPU.

    python3 scripts/moving_order.py [--kind moving|sphere] [--scene S]
                                    [--rays N] [--seed S]

Emulates the wide walk of csrc/traverse_tris.cu in lockstep torch: a stack
a ray, one entry popped a step, the slab test of the wide node's eight
children and the leaf test of trace_plain on the rows the plain walk reads,
the winner of _closest_select (the smallest t, the first row on a tie,
strictly below the running t).  Two orders:

  index     the nodes of pack_nodes, children pushed in ascending slot
            (the last hit slot pops first), no cull: the moving and the
            sphere form's order before their walks took the reference's;
  preorder  the nodes of pack_nodes_preorder (each node's children in
            reverse binary preorder), pushed the same way, so that they pop
            in preorder, and an entry dropped at its pop when the running t
            has passed its entry distance (the box test the kernel makes
            again at a leaf's pop fails exactly then, its box having passed
            at the push): the closest-hit walk of MovingTriangleLeaf and
            SphereLeaf.

Kinds and their rays:
  moving  the 0002_mb frame's triangle tree (data/golden/scenes/0002_mb,
          8,210 triangles, 12 of them moving) on chip_smoke.edge_rays
          (rays aimed at edges that two leaves of the tree share, random
          ray times);
  sphere  a sphere tree (--scene soup: chip_smoke._sphere_soup(2^16, 9),
          phase 3b's; frame: chip_smoke._sphere_scene's 65,536 spheres) on
          chip_smoke.sphere_edge_rays (rays aimed at points where two
          spheres of different leaves meet).
It prints, for each order, the rays whose (t, prim, u, v, slot) differ in a
bit from the plain skip-link walk (trace_plain.walk_plain, the reference's
_traverse).  No card needed.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from corona13_tpu_torch.ops import trace_cuda, trace_plain  # noqa: E402

ORDERS = ('index', 'preorder')
MAX_DIST = trace_plain.MAX_DIST


def wide_walk(bvh, org, direction, time, t, order, kind='moving'):
    """Closest hit of the prims of ``bvh`` (a DeviceBVH of ``kind``,
    'moving' or 'sphere', with its wide layout) by the wide walk in
    ``order``: (t, prim, u, v, slot) with local prim ids, the rays starting
    at ``t`` [N] (a sphere hit leaves u, v and slot as they were)."""
    n = org.shape[0]
    pack = trace_cuda.pack_nodes_preorder if order == 'preorder' else \
        trace_cuda.pack_nodes
    wb = torch.as_tensor(pack(bvh.wbounds.numpy(), bvh.wlinks.numpy()))
    w = wb[:, :, 6]
    link = wb[:, :, 7].contiguous().view(torch.int32).long()
    rank = (7 - torch.arange(8)).expand(wb.shape[0], 8)   # ascending push
    inv = trace_plain.inv_dir(direction)
    t = t.clone()
    prim = torch.full((n,), -1, dtype=torch.long)
    slot = prim.clone()
    u, v = torch.zeros(n), torch.zeros(n)
    stack = torch.zeros((n, trace_cuda.MAX_STACK), dtype=torch.long)
    dist = torch.zeros((n, trace_cuda.MAX_STACK))
    sp = (t > 0).long()
    rows8 = torch.arange(8)
    every = torch.nonzero(sp > 0)[:, 0]
    while every.numel():
        top = sp[every] - 1
        entry, tn_entry = stack[every, top], dist[every, top]
        sp[every] = top
        act = every
        if order != 'index':     # the pop-time cull
            keep = ~(tn_entry > t[every])
            act, entry = every[keep], entry[keep]
        inner = entry >= 0
        ai, ei = act[inner], entry[inner]
        if ai.numel():
            box = wb[ei]
            o, iv = org[ai][:, None, :], inv[ai][:, None, :]
            t0, t1 = (box[:, :, 0:3] - o) * iv, (box[:, :, 3:6] - o) * iv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                               torch.clamp(lo[..., 2], min=0.0))
            tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                               torch.minimum(hi[..., 2], t[ai][:, None]))
            hit = (tn <= tf) & (tf > 0) & (w[ei] != 0)
            val = torch.where(w[ei] >= 256, -link[ei] - 1, link[ei])
            rk = rank[ei]
            # an entry sits below the hit entries that pop before it
            before = (rk[:, None, :] > rk[:, :, None]) & hit[:, None, :]
            pos = sp[ai][:, None] + before.sum(-1)
            ray = ai[:, None].expand(-1, 8)
            stack[ray[hit], pos[hit]] = val[hit]
            dist[ray[hit], pos[hit]] = tn[hit]
            sp[ai] += hit.sum(1)
        al, lid = act[~inner], -entry[~inner] - 1
        if al.numel():
            cslot = lid[:, None] * 8 + rows8
            cand = bvh.leaf_prims[cslot]
            rows1 = bvh.leaf_data_t1[cslot] if kind == 'moving' else None
            tt, bu, bv, ok, _ = trace_plain._candidates(
                kind, bvh.leaf_data[cslot], rows1, org[al], direction[al],
                None if time is None else time[al])
            ok = ok & (cand >= 0) & (tt < t[al][:, None])
            if kind == 'moving':
                t[al], prim[al], u[al], v[al], slot[al] = \
                    trace_plain._closest_select(
                        tt, ok, t[al], prim[al], u[al], v[al], cand, bu, bv,
                        slot=slot[al], cand_slot=cslot)
            else:
                t[al], prim[al], u[al], v[al] = trace_plain._closest_select(
                    tt, ok, t[al], prim[al], u[al], v[al], cand)
        every = every[sp[every] > 0]
    return t, prim, u, v, slot


def differing(a, b):
    """[N] bool: rays whose records differ in a bit."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    out = torch.zeros(a[0].shape[0], dtype=torch.bool)
    for x, y in zip(a, b):
        out |= bits(x) != bits(y)
    return out


def _smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def edge_case(n, seed):
    """(the 0002_mb triangle tree, org, dir, time) on the CPU: n of
    chip_smoke.edge_rays."""
    from corona13_tpu_torch import scene as scene_mod
    cs = _smoke()
    sc = scene_mod.load_scene(cs._scene_path('0002_mb'), device='cpu')[0]
    org, d, tm, _ = cs.edge_rays(sc.geom, n, seed, torch.device('cpu'))
    return sc.geom.tri_bvh, org, d, tm


def sphere_case(scene, n, seed):
    """(a sphere tree, org, dir, None) on the CPU: n of
    chip_smoke.sphere_edge_rays on the soup of phase 3b or on the sphere
    frame's scene."""
    from corona13_tpu_torch.ops import trace as trace_mod
    cs = _smoke()
    cpu = torch.device('cpu')
    if scene == 'soup':
        geom = trace_mod.make_device_geometry(**cs._sphere_soup(1 << 16, 9),
                                              device=cpu)
    else:
        geom = cs._sphere_scene(cpu).geom
    org, d, _ = cs.sphere_edge_rays(geom, n, seed, cpu)
    return geom.sph_bvh, org, d, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--kind', default='moving', choices=('moving', 'sphere'))
    ap.add_argument('--scene', default='soup', choices=('soup', 'frame'))
    ap.add_argument('--rays', type=int, default=1 << 16)
    ap.add_argument('--seed', type=int, default=21)
    args = ap.parse_args()
    if args.kind == 'moving':
        bvh, org, d, tm = edge_case(args.rays, args.seed)
        what = '0002_mb edge rays'
    else:
        bvh, org, d, tm = sphere_case(args.scene, args.rays, args.seed)
        what = f'sphere {args.scene} edge rays'
    n = org.shape[0]
    t = torch.full((n,), MAX_DIST)
    none = torch.full((n,), -1, dtype=torch.long)
    ref = trace_plain.walk_plain(bvh, args.kind, org, d, t, none,
                                 torch.zeros(n), torch.zeros(n), none,
                                 time=tm)
    print(f'{what}: {n} (seed {args.seed}), hit share '
          f'{float((ref[1] >= 0).float().mean()):.4f}')
    for order in ORDERS:
        bad = differing(wide_walk(bvh, org, d, tm, t, order, args.kind), ref)
        print(f'  {order:9s} rays that differ from the skip-link walk: '
              f'{int(bad.sum())}', flush=True)


if __name__ == '__main__':
    main()
