"""The roofline arithmetic: ``chip_smoke.py`` PEAK_*, OPS_* and
``_bound_ms`` (lines 453-483) and OPS_ROW_OF, OPS_PRIM_OF, OPS_LINE_DISC
and ``_form_bound`` (lines 727-743, 806-845) as of commit 2084081, frozen
here, and ``launch_bound``, which counts the work of one captured
traversal launch by the plain skip-link walk of the reference copy and
bounds it by ``_form_bound``."""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
# Float operations, counted from csrc/traverse_tris.cu, min/max and float
# compares each as one.  An inner pop tests a child with 6 subtractions, 6
# multiplications, 12 min/max and 4 compares; a leaf pop tests a row with 54
# (two cross products, four dot products, a divide, three scalings, the
# float compares); a live ray takes 3 clamped inverses (abs, compare,
# select, divide).  The kernel does the arithmetic of all 8 slots of a
# record; the bound counts only the occupied ones, which the walk needs.
OPS_CHILD, OPS_ROW, OPS_RAY = 28, 54, 12


def _bound_ms(b, n, alive, t_is_tensor, n_ignore, out_bytes, inner, leaf):
    """The least time the card could take: (ms, 'bytes' or 'operations').
    Bytes: the kernel's BVH records once, 24 B of origin and direction
    plus 8 B per ignore id for a live ray, t_init where it is a tensor and
    the outputs for every ray.  Operations: those of the pops this run's
    rays made (inner, leaf: totals from the counters launch) on occupied
    children and rows, at the tree's mean fill of a node and of a leaf (the
    counters do not say which records were popped)."""
    child_fill = float((b.knodes[:, :, 6] != 0).float().mean())
    row_fill = float((b.kleaves[:, :, 3].contiguous().view(torch.int32)
                      >= 0).float().mean())
    nbytes = ((b.knodes.numel() + b.kleaves.numel()) * 4
              + alive * (24 + 8 * n_ignore) + n * (4 * t_is_tensor + out_bytes))
    ops = (alive * OPS_RAY + inner * 8 * child_fill * OPS_CHILD
           + leaf * 8 * row_fill * OPS_ROW)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


# Float operations of one leaf row for one ray, counted from
# csrc/traverse_tris.cu as OPS_ROW is: a lerped triangle row adds 27 for the
# nine lerps and 1 for 1 - w to the triangle's 54 (the ray's time enters, so
# none of it is the prim's alone); a sphere takes 25 (3 subtractions, two
# dot products, the subtraction of r*r, the discriminant, max and sqrt, two
# roots, the compares); a cone 75 (3 subtractions, four dot products, s, the
# quadratic's a, b, c and discriminant, max and sqrt, the sign, q, two
# roots, min/max, two acceptance tests, the axial fraction).  OPS_PRIM_OF:
# what a test computes from the prim alone, which the least work does once a
# prim and not once a ray: r*r of a sphere; a cone's axis, its length, the
# three divisions and the slope k, 15.  A node of the skip-link walk is one
# box test, OPS_CHILD.  OPS_LINE_DISC: the cone test up to and with its
# discriminant's compare (3 subtractions, four dot products, s, a, b, c, the
# discriminant), where the line form's kernel leaves a row that misses.
OPS_ROW_OF = {'tri': OPS_ROW, 'moving': OPS_ROW + 28, 'sphere': 25, 'line': 75}
OPS_PRIM_OF = {'tri': 0, 'moving': 0, 'sphere': 1, 'line': 15}
OPS_LINE_DISC = 45


def _form_bound(target, kind, form, n, alive, out_bytes, visits, leafs,
                missed=0):
    """The least time the card could take for one fresh launch of a form:
    (ms, 'bytes' or 'operations').  Bytes: the records the form reads once
    (a tree's nodes and leaf rows, and the sphere form's ids where its rows
    leave them out; a dense list's arrays), 24 B of origin
    and direction and 8 B of ignore id for a live ray, 4 B of ray time for
    a live ray of a form that lerps (moving triangles, a dense sphere list
    with shutter-close centres; the others are given no time), t_init and
    ``out_bytes`` of outputs for every ray.  Operations: 12 a live ray; what
    a test computes from the prim alone once a prim; a tree: one box test a
    node visited and the leaf rows tested, as the plain skip-link walk
    counted them on these rays, at the tree's mean row fill; a dense list:
    every live ray against every prim.  ``missed`` (0: the definition
    above): line rows the plain walk or the plain dense list found with a
    discriminant that is not positive, counted at OPS_LINE_DISC, where the
    kernel leaves them, and not at the full test."""
    if form == 'dense':
        recs = sum(x.numel() for x in target if x is not None) * 4
        n_prims = target[0].shape[0]
        lerps = kind == 'sphere' and target[2] is not None
        ops = (alive * (OPS_RAY + n_prims * (OPS_ROW_OF[kind] + 10 * lerps))
               + n_prims * OPS_PRIM_OF[kind]
               - missed * (OPS_ROW_OF[kind] - OPS_LINE_DISC))
    else:
        nodes = target.knodes if form == 'wide' else target.nodes
        lerps = kind == 'moving'
        rows = [nodes, target.kleaves] + ([target.kleaves_t1] if lerps else [])
        if kind == 'sphere' and target.kleaves.shape[-1] == 4:
            rows.append(target.leaf_prims)   # 16 B rows: the ids apart
        recs = sum(r.numel() * r.element_size() for r in rows)
        filled = target.leaf_prims >= 0
        ops = (alive * OPS_RAY + visits * OPS_CHILD
               + leafs * 8 * float(filled.float().mean()) * OPS_ROW_OF[kind]
               + int(filled.sum()) * OPS_PRIM_OF[kind]
               - missed * (OPS_ROW_OF[kind] - OPS_LINE_DISC))
    nbytes = recs + alive * (24 + 8 + 4 * lerps) + n * (4 + out_bytes)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


def form_of(target):
    """'dense' for a tuple of list arrays, else 'wide', 'deep' or 'skip'
    (``corona13_tpu_torch/ops/trace_cuda.py`` ``_form_of``, lines 885-894
    as of commit 2084081)."""
    if isinstance(target, (tuple, list)):
        return 'dense'
    if target.knodes is not None or target.wbounds is not None:
        return 'wide'
    return 'deep' if target.bnodes is not None else 'skip'


def launch_bound(mode, target, kind, args, kw):
    """(bound ms, 'bytes' or 'operations') of one launch that
    ``_capture.capture_calls`` kept: its live rays (t > 0 and, any-hit,
    not blocked by the carry) and, for a tree, the nodes visited, leaves
    tested and line rows missed at the discriminant by the plain
    skip-link walk from the same running hit, bounded by ``_form_bound``
    with the outputs ``frame_forms`` gives it (1 B any-hit, 28 B
    closest-hit)."""
    from ..reference.tracer.ops import trace_cuda as plain
    from ..reference.tracer.ops import trace_plain
    any_hit = mode == 'any_hit'
    org, direction, t_init = args[:3]
    ig = args[3] if len(args) > 3 else None
    ig2 = args[4] if any_hit and len(args) > 4 else None
    carry, time = kw.get('carry'), kw.get('time')
    n, dev = org.shape[0], org.device
    hit = plain._fresh_hit(n, t_init, dev)
    if any_hit and carry is not None:
        hit = (hit[0], torch.where(carry, 0, -1)) + hit[2:]
    elif carry is not None:
        hit = carry
    live = hit[0] > 0
    if any_hit:
        live = live & (hit[1] < 0)
    alive = int(live.sum())
    form = form_of(target)
    walk = dict(ignore_prim=ig, ignore_prim2=ig2, time=time,
                prim_offset=kw.get('prim_offset', 0), any_hit=any_hit,
                want_counts=True)
    visits = leafs = missed = 0
    if form == 'dense':
        if kind == 'line':
            missed = int(trace_plain.dense_plain(
                kind, target, org, direction, *hit[:4], **walk)[-1].sum())
    else:
        out = trace_plain.walk_plain(target, kind, org, direction, *hit,
                                     **walk)
        visits, leafs, missed = (int(x.sum()) for x in out[5:8])
    return _form_bound(target, kind, form, n, alive, 1 if any_hit else 28,
                       visits, leafs, missed if kind == 'line' else 0)
