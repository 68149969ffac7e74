"""Preetham analytic daylight sky (corona13_tpu/models/daylight.py;
corona-13 src/shaders/daylight.h).

Sky spectra are the CIE daylight basis S0 + M1*S1 + M2*S2 scaled by the
Perez luminance distribution ("A Practical Analytic Model for Daylight",
Preetham et al. 1999: the polynomial constants are the paper's Appendix A
tables and the CIE daylight-basis and sun-irradiance data, public
constants), plus a sun disc whose spectrum passes through the
Rayleigh/aerosol/ozone/water transmittance chain.  Everything per direction
is closed-form math over the wavefront; the sun- and turbidity-dependent
scalars are precomputed on the host in ``build``, in float64 as there.

Kept as the JAX package has them (its defects on record): the ozone table
``K_O`` starts at 450 nm but ``build`` indexes it from 380 nm; directions
down to z > -0.3 still receive sky radiance (no cutoff at the horizon).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.math import sqrt

# CIE daylight basis, 380..780 nm in 10 nm steps (41 entries)
S0 = np.array([63.4, 65.8, 94.8, 104.8, 105.9, 96.8, 113.9, 125.6, 125.5,
               121.3, 121.3, 113.5, 113.1, 110.8, 106.5, 108.8, 105.3,
               104.4, 100, 96, 95.1, 89.1, 90.5, 90.3, 88.4, 84, 85.1,
               81.9, 82.6, 84.9, 81.3, 71.9, 74.3, 76.4, 63.3, 71.7, 77,
               65.2, 47.7, 68.6, 65], np.float32)
S1 = np.array([38.5, 35, 43.4, 46.3, 43.9, 37.1, 36.7, 35.9, 32.6, 27.9,
               24.3, 20.1, 16.2, 13.2, 8.6, 6.1, 4.2, 1.9, 0, -1.6, -3.5,
               -3.5, -5.8, -7.2, -8.6, -9.5, -10.9, -10.7, -12, -14,
               -13.6, -12, -13.3, -12.9, -10.6, -11.6, -12.2, -10.2,
               -7.8, -11.2, -10.4], np.float32)
S2 = np.array([3, 1.2, -1.1, -0.5, -0.7, -1.2, -2.6, -2.9, -2.8, -2.6,
               -2.6, -1.8, -1.5, -1.3, -1.2, -1, -0.5, -0.3, 0, 0.2, 0.5,
               2.1, 3.2, 4.1, 4.7, 5.1, 6.7, 7.3, 8.6, 9.8, 10.2, 8.3,
               9.6, 8.5, 7, 7.6, 8, 6.7, 5.2, 7.4, 6.8], np.float32)
# sun spectral radiance 380..750 nm @10 nm (Preetham Table 2, W/cm^2/um/sr)
SUN_RAD = np.array([1655.9, 1623.37, 2112.75, 2588.82, 2582.91, 2423.23,
                    2676.05, 2965.83, 3054.54, 3005.75, 3066.37, 2883.04,
                    2871.21, 2782.5, 2710.06, 2723.36, 2636.13, 2550.38,
                    2506.02, 2531.16, 2535.59, 2513.42, 2463.15, 2417.32,
                    2368.53, 2321.21, 2282.77, 2233.98, 2197.02, 2152.67,
                    2109.79, 2072.83, 2024.04, 1987.08, 1942.72, 1907.24,
                    1862.89, 1825.92], np.float64)
K_O = np.array([0.003, 0.006, 0.009, 0.014, 0.021, 0.03, 0.04, 0.048,
                0.063, 0.075, 0.085, 0.103, 0.12, 0.12, 0.115, 0.125,
                0.12, 0.105, 0.09, 0.079, 0.067, 0.057, 0.048, 0.036,
                0.028, 0.023, 0.018, 0.014, 0.011, 0.01, 0.009, 0.007,
                0.004, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)  # from 450nm
K_G = np.array([3.0, 0.21], np.float64)                       # 760,770nm
K_WA = np.array([0.016, 0.024, 0.0125, 1, 0.87, 0.061, 0.001, 1e-05,
                 1e-05, 0.0006], np.float64)                  # from 690nm
SUN_RADIUS = 0.0088   # radians (daylight.h sun_rad)


@dataclasses.dataclass
class DaylightSky:
    sun_dir: torch.Tensor      # [3] unit, pointing TOWARD the sun
    perez: torch.Tensor        # [3, 5] coefficients for (x, y, Y)
    zenith: torch.Tensor       # [3] zenith (x, y, Y)
    theta_sun: torch.Tensor    # 0-d
    sun_power: torch.Tensor    # [41] spectral radiance of the sun disc
    mul: torch.Tensor          # 0-d user gain
    # the CIE daylight basis rows (S0, S1, S2) [3, 41] beside the other
    # tables; filled in when not given (a sky carried over from the JAX
    # package has none)
    basis: torch.Tensor | None = None

    def __post_init__(self):
        if self.basis is None:
            self.basis = torch.as_tensor(np.stack([S0, S1, S2]),
                                         device=self.sun_power.device)


def build(sun_dir, turbidity: float = 2.5, mul: float = 1.0,
          device='cuda') -> DaylightSky:
    """Precompute the Perez/zenith/sun terms (daylight.h:100-145 +
    compute_sun_XYZ:54-96) on the host and put them on ``device``.
    sun_dir points toward the sun (z up)."""
    d = np.asarray(sun_dir, np.float64)
    d = d / np.linalg.norm(d)
    t = float(np.clip(turbidity, 2.0, 10.0))
    theta = float(np.arccos(np.clip(d[2], 0.0, 1.0)))
    th2, th3 = theta * theta, theta ** 3
    zen = np.array([
        (0.00166 * th3 - 0.00375 * th2 + 0.00209 * theta) * t * t +
        (-0.02903 * th3 + 0.06377 * th2 - 0.03203 * theta + 0.00394) * t +
        (0.11693 * th3 - 0.21196 * th2 + 0.06052 * theta + 0.25886),
        (0.00275 * th3 - 0.00610 * th2 + 0.00317 * theta) * t * t +
        (-0.04214 * th3 + 0.08970 * th2 - 0.04153 * theta + 0.00516) * t +
        (0.15346 * th3 - 0.26756 * th2 + 0.06670 * theta + 0.26688),
        (4.0453 * t - 4.9710) * np.tan((4.0 / 9.0 - t / 120.0)
                                       * (np.pi - 2 * theta))
        - 0.2155 * t + 2.4192], np.float32)
    perez = np.array([
        [-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
         -0.0641 * t - 0.8989, -0.0033 * t + 0.0452],
        [-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
         -0.0441 * t - 1.6537, -0.0109 * t + 0.0529],
        [0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
         0.1206 * t - 2.5771, -0.0679 * t + 0.3703]], np.float32)

    # sun spectrum through the atmosphere (compute_sun_XYZ)
    m = 1.0 / (np.cos(theta) + 0.15 * (93.885 - np.degrees(theta)) ** -1.253)
    beta = 0.04608 * t + 0.04586
    power_scale = 400.0 / (t * t)
    sun_power = np.zeros(41, np.float32)
    for k in range(38):                      # 380..750 nm
        lam_um = (38 + k) / 100.0
        tau = np.exp(-m * 0.008735 * lam_um ** -4.08)
        tau *= np.exp(-m * beta * lam_um ** -1.3)
        tau *= np.exp(-K_O[k] * 0.35 * m)    # K_O[0] is 450 nm (see above)
        i10 = 38 + k
        if 76 <= i10 <= 77:
            kg = K_G[i10 - 76]
            tau *= np.exp((-1.41 * kg * m)
                          / (1.0 + 118.93 * kg * m) ** 0.45)
        if 69 <= i10 <= 78:
            kw = K_WA[i10 - 69]
            tau *= np.exp((-0.2385 * kw * 2.0 * m)
                          / (1.0 + 20.07 * kw * 2.0 * m) ** 0.45)
        sun_power[k] = power_scale * tau * SUN_RAD[k] * 38.0 * 20.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return DaylightSky(sun_dir=f(d), perez=f(perez), zenith=f(zen),
                       theta_sun=f(theta), sun_power=f(sun_power), mul=f(mul))


def _perez(coeff, theta_sun, theta_v, gamma):
    """Perez distribution ratio (daylight.h DistributionPerez)."""
    cg2 = torch.cos(gamma) ** 2
    p0 = (1 + coeff[0] * torch.exp(coeff[1] / torch.cos(theta_v))) * \
        (1 + coeff[2] * torch.exp(coeff[3] * gamma) + coeff[4] * cg2)
    p1 = (1 + coeff[0] * torch.exp(coeff[1])) * \
        (1 + coeff[2] * torch.exp(coeff[3] * theta_sun)
         + coeff[4] * torch.cos(theta_sun) ** 2)
    return p0 / p1


def _basis_lerp(table, lam):
    """10 nm lerp of a [41] basis row at lam [.., MF] nm (380..780)."""
    f = torch.clamp((lam - 380.0) / 10.0, 0.0, 40.0)
    i = torch.clamp(torch.floor(f).to(torch.int64), 0, 39)
    w = f - i
    return table[i] * (1.0 - w) + table[i + 1] * w


def eval_radiance(sky: DaylightSky, direction, lam):
    """Spectral sky radiance for escape directions [N, 3] at lam [N, MF]
    (daylight.h sky_daylight): Perez (x, y, Y) -> CIE daylight basis,
    plus the sun disc within SUN_RADIUS."""
    d = direction
    cos_g = torch.clamp(torch.sum(d * sky.sun_dir, dim=-1), -1.0, 1.0)
    gamma = torch.acos(cos_g)
    dz = torch.clamp(d[..., 2], min=0.01)
    theta_v = torch.acos(dz / sqrt(
        d[..., 0] ** 2 + d[..., 1] ** 2 + dz * dz))
    x, y, yy = (sky.zenith[k] * _perez(sky.perez[k], sky.theta_sun, theta_v,
                                       gamma) for k in range(3))
    den = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / den
    m2 = (0.03 - 31.4424 * x + 30.0717 * y) / den
    s0, s1, s2 = (_basis_lerp(row, lam) for row in sky.basis)
    sky_spec = yy[..., None] * (s0 + m1[..., None] * s1
                                + m2[..., None] * s2)
    sun_spec = _basis_lerp(sky.sun_power, lam)
    out = sky_spec + torch.where((gamma < SUN_RADIUS)[..., None],
                                 sun_spec, 0.0)
    # no cutoff at the horizon: down to z > -0.3 (see the module docstring)
    valid = direction[..., 2] > -0.3
    return torch.where(valid[..., None], torch.clamp(out, min=0.0),
                       0.0) * sky.mul
