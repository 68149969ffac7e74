"""The traversal launches of one progression with their arguments:
``chip_smoke.py`` ``_cloned`` and ``_capture_calls`` (lines 3024-3065 as of
commit 2084081), frozen here."""

from __future__ import annotations

import torch


def _cloned(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(y) for y in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


def capture_calls(fn, n_lanes, picks):
    """Run fn with trace_cuda.closest_hit and any_hit wrapped.  A call of
    trace.intersect / occluded launches one form per prim kind, the first
    without a carry; for the picks[mode]-th such call on n_lanes rays
    (0-based; a collection of indices keeps each of them), keep each
    launch's arguments as the form was given them (the carry cloned before
    the launch updates it in place), in the order of the launches."""
    from corona13_tpu_torch.ops import trace_cuda
    real = {m: getattr(trace_cuda, m) for m in picks}
    want = {m: {p} if isinstance(p, int) else set(p)
            for m, p in picks.items()}
    seen = {m: -1 for m in picks}
    kept = {m: [] for m in picks}

    def wrapped(mode):
        def call(target, kind, org, *a, **kw):
            if org.shape[0] == n_lanes:
                seen[mode] += kw.get('carry') is None
                if seen[mode] in want[mode]:
                    kept[mode].append((target, kind, _cloned((org,) + a),
                                       _cloned(kw)))
            return real[mode](target, kind, org, *a, **kw)
        return call
    for m in picks:
        setattr(trace_cuda, m, wrapped(m))
    try:
        with torch.no_grad():
            fn()
    finally:
        for m, f in real.items():
            setattr(trace_cuda, m, f)
    return kept
