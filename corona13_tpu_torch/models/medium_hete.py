"""Heterogeneous participating media on a dense density grid
(corona13_tpu/models/medium_hete.py).

The reference's out-of-core 512-ary voxel octree (corona-13
src/shaders/medium_hete.c + include/vol/trace.h) becomes dense density and
temperature arrays in device memory, traced by a fixed-step regular march:
[N, K] gathers and cumulative sums instead of a per-ray DDA.

  * transmittance: quadrature along the ray-AABB overlap,
    tau = sum sigma_t * rho(x_i) * dx;
  * distance sampling: invert the piecewise-constant optical depth for a
    target -log(1-xi), pdf = mu_t(x) * T(x);
  * extinction: mu_t = density * sigma_t with scalar sigma_t/sigma_s
    (medium_hete.c:45-47), so the spectral axis is flat and only the
    scalar factor sigma_s/sigma_t applies at scatter events.

Interpolation is nearest-voxel.  This is dense gather and cumsum work in
plain torch (the JAX package runs it outside any Pallas kernel too); at
589,824 lanes the [N, 64, 3] march positions take about 450 MB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

N_MARCH = 64   # quadrature / inversion steps per segment


@dataclasses.dataclass
class VolGrid:
    density: torch.Tensor      # [Z, Y, X] float32
    temperature: torch.Tensor  # [Z, Y, X] float32
    lo: torch.Tensor           # [3] world-space aabb
    hi: torch.Tensor           # [3]
    sigma_t: torch.Tensor      # 0-d extinction scale (mu_t = rho * sigma_t)
    sigma_s: torch.Tensor      # 0-d scattering scale
    sigma_e: torch.Tensor      # 0-d emission scale (blackbody x temp)
    g0: torch.Tensor           # 0-d HG mean cosine
    mat_id: int = -1


def from_volfile(vf, sigma_s, sigma_t, sigma_e, g0, mat_id, *,
                 device) -> VolGrid:
    """Build the device grid from io.vol.VolFile.  World placement uses the
    file's aabb (+ loc offset); rotation is not supported."""
    lo = np.asarray(vf.aabb[:3], np.float32) + vf.loc
    hi = np.asarray(vf.aabb[3:], np.float32) + vf.loc
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    f0 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=device)
    return VolGrid(density=t(vf.density), temperature=t(vf.temperature),
                   lo=t(lo), hi=t(hi), sigma_t=f0(sigma_t), sigma_s=f0(sigma_s),
                   sigma_e=f0(sigma_e), g0=f0(g0), mat_id=mat_id)


def _voxel(grid: VolGrid, field, x):
    """Nearest-voxel flat index into ``field`` [Z, Y, X] at world positions
    x [..., 3], and whether x lies inside the grid."""
    shape = torch.tensor(field.shape[::-1], device=x.device)   # (X, Y, Z)
    res = shape.to(torch.float32)
    rel = (x - grid.lo) / torch.clamp(grid.hi - grid.lo, min=1e-20) * res
    inside = torch.all((rel >= 0.0) & (rel < res), dim=-1)
    ijk = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int64), min=0),
                        shape - 1)
    flat = (ijk[..., 2] * field.shape[1] + ijk[..., 1]) * field.shape[2] \
        + ijk[..., 0]
    return flat, inside


def density_at(grid: VolGrid, x):
    """Nearest-voxel density at world positions x [..., 3]."""
    flat, inside = _voxel(grid, grid.density, x)
    return torch.where(inside, grid.density.reshape(-1)[flat], 0.0)


def _segment(grid: VolGrid, org, w, t_max):
    """Ray-AABB overlap [a, b] clipped to [0, t_max]."""
    inv = 1.0 / torch.where(torch.abs(w) < 1e-20, 1e-20, w)
    t0 = (grid.lo - org) * inv
    t1 = (grid.hi - org) * inv
    a = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    b = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1),
                      torch.clamp(t_max, max=1e4))
    return a, torch.maximum(b, a)


def _march_x(org, w, a, b):
    """Midpoints x_i [N, K, 3] of the K march steps along [a, b] and the
    step length dx [N]."""
    dx = (b - a) / N_MARCH
    i = torch.arange(N_MARCH, dtype=torch.float32, device=org.device) + 0.5
    t_i = a[..., None] + i * dx[..., None]                    # [N, K]
    return org[..., None, :] + t_i[..., None] * w[..., None, :], dx


def _march_tau(grid: VolGrid, org, w, a, b):
    """Per-step optical depths dtau [N, K] at midpoints along [a, b]."""
    x_i, dx = _march_x(org, w, a, b)
    rho = density_at(grid, x_i)                               # [N, K]
    return rho * grid.sigma_t * dx[..., None], dx


def transmittance(grid: VolGrid, org, w, dist):
    """exp(-integral mu_t) along [0, dist] from org (scalar, [N])."""
    a, b = _segment(grid, org, w, dist)
    dtau, _ = _march_tau(grid, org, w, a, b)
    return torch.exp(-torch.sum(dtau, dim=-1))


def sample_dist(grid: VolGrid, org, w, t_hit, rnd):
    """Voxel-based free-flight distance sampling.

    Returns (scatter [N] bool, dist [N], weight [N]): weight is the scalar
    throughput factor (sigma_s/sigma_t at a scatter event; survival to the
    surface has weight 1 with pdf = T(t_hit), as in medium.sample_dist)."""
    a, b = _segment(grid, org, w, t_hit)
    dtau, dx = _march_tau(grid, org, w, a, b)
    cum = torch.cumsum(dtau, dim=-1)                          # [N, K]
    target = -torch.log(torch.clamp(1.0 - rnd, min=1e-20))
    crossed = cum >= target[..., None]
    any_cross = torch.any(crossed, dim=-1)
    k = torch.argmax(crossed.to(torch.int32), dim=-1)         # first crossing
    cum_before = torch.where(
        k > 0, torch.gather(cum, -1, torch.clamp(k - 1, min=0)[..., None]
                            )[..., 0], 0.0)
    dtau_k = torch.gather(dtau, -1, k[..., None])[..., 0]
    frac = (target - cum_before) / torch.clamp(dtau_k, min=1e-20)
    dist = a + (k.to(torch.float32) + torch.clamp(frac, 0.0, 1.0)) * dx
    scatter = any_cross & (dist < t_hit)
    ratio = torch.where(grid.sigma_t > 0.0,
                        grid.sigma_s / torch.clamp(grid.sigma_t, min=1e-20),
                        0.0)
    weight = torch.where(scatter, ratio, 1.0)
    return scatter, torch.where(scatter, dist, t_hit), weight


def emission_along(grid: VolGrid, org, w, dist, lam):
    """Accumulated blackbody emission along [0, dist]:
    sum T(t_i) * sigma_e * rho_i * Le(T_i, lam) * dx (SEGMENT_EMISSION in
    vol/trace.h:27-33).  Returns [N, MF]."""
    from ..spectral import cie
    a, b = _segment(grid, org, w, dist)
    x_i, dx = _march_x(org, w, a, b)
    rho = density_at(grid, x_i)
    flat, _ = _voxel(grid, grid.temperature, x_i)
    temp = grid.temperature.reshape(-1)[flat]
    dtau = rho * grid.sigma_t * dx[..., None]
    tr = torch.exp(-(torch.cumsum(dtau, dim=-1) - dtau))     # T up to bin
    le = cie.blackbody(temp[..., None], lam[..., None, :])    # [N, K, MF]
    contrib = (tr * grid.sigma_e * rho * dx[..., None])[..., None] * le
    return torch.sum(contrib, dim=-2)
