"""The deep walk against the reference's skip-link walk, on the CPU.

    python3 scripts/deep_order.py [--trees zoom,zoom_edges,plane_edges,soup]
                                  [--film W,H] [--rays N] [--seed S]

Emulates the deep walk of csrc/traverse_tris.cu (deep_kernel) in lockstep
torch on the records it reads (trace_cuda.pack_bin_nodes: a binary node
holds both children's boxes and links): a ray first tests the root's box;
at an inner node it tests both children's boxes at the running t, goes on
to the left child if its box is hit and pushes the node if the right box
is hit too (else goes to the right child); a leaf child's filled rows are
tested when the walk reaches it, with trace_plain's leaf tests and
_closest_select's winner; a pop tests the pushed node's right box again at
the running t, as the skip-link walk does when it reaches that child, and
drops it on a miss.  Two orders:

  kept   the walk above;
  nocull the same without the test at the pop: a right child whose box
         was hit at its parent is reached whatever the running t.

Trees and their rays (--trees names a subset):
  zoom         chip_smoke._zoom_scene's tree (65,536-triangle log-spiral
               ribbon, ground and light; no wide layout) on every
               closest-hit and any-hit launch of one pt progression at
               --film (default 256,144), captured from the frame's calls;
  zoom_edges   the same tree on chip_smoke.edge_rays (rays aimed at edges
               two leaves share; shadow segments ending at them);
  plane_edges  the plane scene's tree (trace.without_wide) on its edge
               rays;
  soup         chip_smoke.py's 2^17-triangle soup (trace.without_wide) on
               the first --rays of its bounce rays and shadow segments.
For each, closest-hit and any-hit: the rays whose (t, prim, u, v, slot),
or blocked flag, differ in a bit from the plain skip-link walk
(trace_plain.walk_plain, the reference's _traverse), the skip-link walk's
nodes and leaves a ray, the deep walk's node records and leaves a ray
(mean, p99, max) and the stack entries it reaches (max, p99.9).  No card
needed.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from corona13_tpu_torch.ops import bvh as bvh_mod  # noqa: E402
from corona13_tpu_torch.ops import trace as trace_mod  # noqa: E402
from corona13_tpu_torch.ops import trace_cuda, trace_plain  # noqa: E402

ORDERS = ('kept', 'nocull')
MAX_DIST = trace_plain.MAX_DIST
LEAF = bvh_mod.LEAF_SIZE


def _box(rec, org, inv, t):
    """(hit, tn) of boxes rec [k, 6] (min3, max3) for rays (org, inv [k, 3],
    t [k]) as the skip-link walk tests a node."""
    t0, t1 = (rec[:, 0:3] - org) * inv, (rec[:, 3:6] - org) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.clamp(torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                                   lo[:, 2]), min=0.0)
    tf = torch.minimum(torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                                     hi[:, 2]), t)
    return tn <= tf, tn


def deep_walk(bvh, kind, org, direction, t, prim, u, v, slot,
              ignore_prim=None, ignore_prim2=None, time=None, any_hit=False,
              cull=True):
    """The deep walk of ``bvh`` (a DeviceBVH with ``bnodes``) for a
    wavefront, from the running hit (t, prim, u, v, slot) as
    trace_plain.walk_plain takes it (local prim ids; any-hit: prim >= 0 is
    blocked already).  Returns the updated hit and per ray: node records
    loaded, leaves tested, the most stack entries held.  cull=False: no
    box test at the pop."""
    rec = bvh.bnodes
    links = rec[:, 12:14].contiguous().view(torch.int32).long()
    inv = trace_plain.inv_dir(direction)
    t, prim, u, v, slot = (x.clone() for x in (t, prim, u, v, slot))
    n = org.shape[0]
    depth = max(bvh.bin_depth, 1)
    stack = torch.zeros((n, depth), dtype=torch.long)   # pushed records
    sp = torch.zeros(n, dtype=torch.long)
    most = torch.zeros(n, dtype=torch.long)
    steps = torch.zeros(n, dtype=torch.long)
    leafs = torch.zeros(n, dtype=torch.long)
    data = bvh.kleaves.reshape(-1, bvh.kleaves.shape[-1]) if kind == 'line' \
        else bvh.leaf_data
    live = t > 0
    if any_hit:
        live = live & (prim < 0)
    # the root's box, as record 0 holds it
    e = torch.zeros(n, dtype=torch.long)
    root = rec[0:1, 0:6].expand(n, 6)
    hit, _ = _box(root, org, inv, t)
    e[live & hit] = links[0, 0]

    def pop(ids):
        e[ids] = 0
        while ids.numel():
            ids = ids[sp[ids] > 0]
            sp[ids] -= 1
            x = stack[ids, sp[ids]]
            keep = _box(rec[x, 6:12], org[ids], inv[ids], t[ids])[0] \
                if cull else torch.ones_like(x, dtype=bool)
            e[ids[keep]] = links[x[keep], 1]
            ids = ids[~keep]

    act = torch.nonzero(e != 0)[:, 0]
    while act.numel():
        ea = e[act]
        ai, ei = act[ea > 0], ea[ea > 0]
        if ai.numel():
            steps[ai] += 1
            r = rec[ei]
            o, iv, ta = org[ai], inv[ai], t[ai]
            hl, _ = _box(r[:, 0:6], o, iv, ta)
            hr, _ = _box(r[:, 6:12], o, iv, ta)
            both = hl & hr
            b = ai[both]
            stack[b, sp[b]] = ei[both]
            sp[b] += 1
            most[b] = torch.maximum(most[b], sp[b])
            e[ai] = torch.where(hl, links[ei, 0], links[ei, 1])
            pop(ai[~hl & ~hr])
        al, code = act[ea < 0], -ea[ea < 0] - 1
        if al.numel():
            leafs[al] += 1
            lid, rows = code // LEAF, code % LEAF + 1
            cslot = lid[:, None] * LEAF + torch.arange(LEAF)
            cand = bvh.leaf_prims[cslot]
            rows1 = bvh.leaf_data_t1[cslot] if kind == 'moving' else None
            tt, uu, vv, ok, _ = trace_plain._candidates(
                kind, data[cslot], rows1, org[al], direction[al],
                None if time is None else time[al])
            ok = ok & (torch.arange(LEAF) < rows[:, None]) & (cand >= 0) \
                & (tt < t[al][:, None]) & trace_plain._not_ignored(
                    cand, None if ignore_prim is None else ignore_prim[al],
                    None if ignore_prim2 is None else ignore_prim2[al])
            if any_hit:
                blocked = ok.any(dim=-1)
                prim[al[blocked]] = 0
                e[al[blocked]] = 0
                pop(al[~blocked])
            else:
                if kind in ('tri', 'moving'):
                    t[al], prim[al], u[al], v[al], slot[al] = \
                        trace_plain._closest_select(
                            tt, ok, t[al], prim[al], u[al], v[al], cand, uu,
                            vv, slot=slot[al], cand_slot=cslot)
                else:
                    t[al], prim[al], u[al], v[al] = \
                        trace_plain._closest_select(
                            tt, ok, t[al], prim[al], u[al], v[al], cand, uu,
                            vv)
                pop(al)
        act = act[e[act] != 0]
    return (t, prim, u, v, slot), steps, leafs, most


def _smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _fresh(n, t):
    none = torch.full((n,), -1, dtype=torch.long)
    t = t if torch.is_tensor(t) else torch.full((n,), float(t))
    return t, none, torch.zeros(n), torch.zeros(n), none.clone()


def compare(bvh, kind, org, d, t, ignore=None, ignore2=None, time=None,
            any_hit=False, order='kept'):
    """One launch's rays by the deep walk in ``order`` and by walk_plain:
    (rays differing in a bit, the plain walk's nodes and leaves a ray, the
    deep walk's records and leaves a ray, its stack entries a ray)."""
    n = org.shape[0]
    kw = dict(ignore_prim=ignore, ignore_prim2=ignore2, time=time,
              any_hit=any_hit)
    ref, visits, pleafs, _ = (lambda o: (o[:5], o[5], o[6], o[7]))(
        trace_plain.walk_plain(bvh, kind, org, d, *_fresh(n, t),
                               want_counts=True, **kw))
    got, steps, leafs, most = deep_walk(bvh, kind, org, d, *_fresh(n, t),
                                        cull=order == 'kept', **kw)
    if any_hit:
        differ = (got[1] >= 0) != (ref[1] >= 0)
    else:
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 \
            else x
        differ = torch.zeros(n, dtype=torch.bool)
        for a, b in zip(got, ref):
            differ |= bits(a) != bits(b)
    return int(differ.sum()), visits, pleafs, steps, leafs, most


def _stats(x):
    x = x.double()
    return (f'{float(x.mean()):.2f} (p99 {float(torch.quantile(x, 0.99)):.0f}'
            f', max {int(x.max())})')


def report(name, bvh, kind, org, d, t, ignore=None, ignore2=None,
           any_hit=False):
    for order in ORDERS:
        bad, visits, pleafs, steps, leafs, most = compare(
            bvh, kind, org, d, t, ignore, ignore2, None, any_hit, order)
        mode = 'any' if any_hit else 'closest'
        line = (f'  {name:26s} {mode:7s} {order:6s} {org.shape[0]} rays: '
                f'differ {bad}')
        if order == 'kept':
            m = most.double()
            line += (f'; skip-link walk nodes {_stats(visits)}, leaves '
                     f'{_stats(pleafs)}; deep walk records {_stats(steps)}, '
                     f'leaves {_stats(leafs)}, stack max {int(m.max())} '
                     f'p99.9 {float(torch.quantile(m, 0.999)):.0f}')
        print(line, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trees', default='zoom,zoom_edges,plane_edges,soup')
    ap.add_argument('--film', default='256,144')
    ap.add_argument('--rays', type=int, default=1 << 16)
    ap.add_argument('--seed', type=int, default=21)
    args = ap.parse_args()
    trees = args.trees.split(',')
    torch.manual_seed(0)
    cs = _smoke()
    cpu = torch.device('cpu')
    from corona13_tpu_torch import scene as scene_mod
    from corona13_tpu_torch import testing
    from corona13_tpu_torch.samplers import pt as pt_mod
    if {'zoom', 'zoom_edges'} & set(trees):
        zoom = cs._zoom_scene(cpu)
        b = zoom.geom.tri_bvh
        flat = bvh_mod.flat_from_nodes(b.nodes.numpy(), b.leaf_prims.numpy())
        wdepth = bvh_mod.collapse8(flat)[2]
        print(f'zoom tree: {zoom.geom.n_tris} triangles, form '
              f'{trace_cuda._form_of(b, "tri")}, wdepth {wdepth} (wide stack '
              f'{wdepth * 7 + 8}), binary depth {b.bin_depth} levels, '
              f'{b.n_nodes} binary nodes, {b.bnodes.shape[0]} deep records',
              flush=True)
    if 'zoom' in trees:
        w, h = (int(x) for x in args.film.split(','))
        sc = scene_mod.fit_film(zoom, w, h)
        cfg = pt_mod.PTConfig(width=w, height=h, max_verts=6, mf=4,
                              use_nee=True)
        for mode, calls in cs.frame_calls(sc, cfg).items():
            for i, (target, kind, a, kw) in enumerate(calls):
                # one prim kind: the launch has no carry
                any_hit = mode == 'any_hit'
                report(f'zoom frame launch {i + 1}', target, kind, a[0], a[1],
                       a[2], a[3], a[4] if any_hit else None, any_hit)
    if 'zoom_edges' in trees:
        org, d, _, seg = cs.edge_rays(zoom.geom, args.rays, args.seed, cpu)
        report('zoom edge rays', b, 'tri', org, d, MAX_DIST)
        report('zoom edge rays', b, 'tri', org, d, seg, any_hit=True)
    if 'plane_edges' in trees:
        plane = testing.plane_scene(device=cpu)
        deep = trace_mod.without_wide(plane.geom.tri_bvh)
        org, d, _, seg = cs.edge_rays(plane.geom, args.rays, args.seed, cpu)
        report('plane edge rays', deep, 'tri', org, d, MAX_DIST)
        report('plane edge rays', deep, 'tri', org, d, seg, any_hit=True)
    if 'soup' in trees:
        soup = trace_mod.make_device_geometry(tri_v=cs._soup(1 << 17, 7),
                                              device=cpu)
        deep = trace_mod.without_wide(soup.tri_bvh)
        print(f'soup tree: binary depth {deep.bin_depth} levels, '
              f'{deep.n_nodes} binary nodes', flush=True)
        rays = cs._soup_sets(cpu, 5)
        k = args.rays
        o, dd, _ = (x[:k] for x in rays['bounce'])
        report('soup bounce', deep, 'tri', o, dd, MAX_DIST)
        so, sd, _, seg = (x[:k] for x in rays['shadow'])
        report('soup shadow', deep, 'tri', so, sd, seg, any_hit=True)


if __name__ == '__main__':
    main()
