"""Nested-media priority stack (corona13_tpu/models/medium.py:140-170).

Only the stack is ported: the path tracer carries it even with media off.
A small fixed-depth sorted set of interior material ids per lane; the
current medium is the minimum id; empty slots sort to the top.
"""

from __future__ import annotations

import torch

MED_STACK_DEPTH = 4
MED_EMPTY = 0x7fffffff


def stack_init(template):
    """Empty stack [N, D] shaped like ``template`` [N]."""
    return torch.full(template.shape + (MED_STACK_DEPTH,), MED_EMPTY,
                      dtype=torch.int64, device=template.device)


def stack_current(stack):
    """Active interior material id per lane (-1 = vacuum)."""
    m = torch.amin(stack, dim=-1)
    return torch.where(m == MED_EMPTY, -1, m)


def stack_push(stack, mat, do):
    """Insert ``mat`` where ``do``; on overflow the largest id (lowest
    priority) falls off."""
    entry = torch.where(do, mat, MED_EMPTY)
    ext = torch.cat([stack, entry[..., None]], dim=-1)
    ext = torch.sort(ext, dim=-1).values
    return ext[..., :MED_STACK_DEPTH]
