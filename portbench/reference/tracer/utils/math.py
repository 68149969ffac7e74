# Frozen copy of corona13_tpu_torch/utils/math.py (lines 1-128) as of commit 2084081, for the benchmark's plain reference.
"""Small vector-math helpers shared across the port (corona13_tpu/utils/math.py).

All functions operate on trailing-axis-3 tensors and broadcast over
leading (wavefront) axes.
"""

from __future__ import annotations


import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x``, the same bits on every
    device: every root the port takes of a tensor comes through here.

    torch's vectorized float32 ``sqrt`` on the CPU is not correctly
    rounded: on large tensors about 0.6% of its roots are one ulp low.  A
    double carries more than 2 * 24 + 2 bits, so the double's root rounded
    to float32 is the correctly rounded float32 root, and that is the CPU
    branch.  On CUDA ``torch.sqrt`` is correctly rounded (IEEE ``sqrt``, as
    the JAX package's ``jnp.sqrt`` and the traversal kernel's ``sqrtf``
    under ``-prec-sqrt=true``), and ``chip_smoke.py``'s rounding phase holds
    it to the CPU branch bit for bit over every exponent: the two branches
    compute one function, neither is a fallback.  Other dtypes go to
    ``torch.sqrt`` as they are; the port takes no float64 root of a tensor
    (its float64 work, the daylight model's host terms, is numpy).
    Autograd runs through the branch taken.
    """
    if x.dtype == torch.float32 and x.device.type == 'cpu':
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` with the correctly rounded root and an IEEE division.

    On the CPU these are the bits of ``torch.rsqrt``, which divides one by
    a correctly rounded root.  On CUDA ``torch.rsqrt`` is the hardware's
    approximation (to 2 ulp), so the card takes this division instead and
    gives the CPU's bits."""
    return torch.reciprocal(sqrt(x))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return a * rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


def build_onb(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal basis (u, v) perpendicular to unit n (branch-free Duff
    et al., JCGT 2017)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    u = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    v = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return u, v


def from_frame(u, v, n, wl):
    """Local coordinates -> world direction."""
    return wl[..., 0:1] * u + wl[..., 1:2] * v + wl[..., 2:3] * n


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate vector p by quaternion q = [w, x, y, z]."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * cross(u, p)
    return p + w * t + cross(u, t)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Normalized linear interpolation (the reference's quaternion_slerp
    is also a nlerp)."""
    q = (1.0 - t) * q0 + t * q1
    return q / torch.clamp(sqrt(torch.sum(q * q, dim=-1, keepdim=True)),
                           min=1e-20)


def ray_offset(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Scale-relative self-intersection offset along the ray direction
    (not along the normal, like the reference's prims_offset_ray)."""
    eps = 1e-4 * torch.clamp(torch.amax(torch.abs(x), dim=-1), min=0.5)
    return x + eps[..., None] * d
