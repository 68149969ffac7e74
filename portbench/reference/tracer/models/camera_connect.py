# Frozen copy of corona13_tpu_torch/models/camera.py (lines 72-127: pdf_connect and connect) as of commit 9ac2600, for the benchmark's plain reference of bdpt.
"""The thin lens's connection of world vertices to its aperture, for the
light-path samplers (corona13_tpu/models/camera.py)."""

from __future__ import annotations

import math

import torch

from ..utils.math import sqrt
from .camera import SENSOR_RESPONSE, aperture_area, cam_frame


def pdf_connect(camera, cos_ap):
    """Projected-solid-angle pdf of the camera sampling a direction whose
    cosine to the view axis is ``cos_ap``: sample()'s pdf_proj for that
    direction.  The reverse pdf of the camera-adjacent vertex in BDPT's
    t = 1 MIS."""
    cos_ap = torch.clamp(cos_ap, min=1e-6)
    g = cos_ap ** 4 / (camera.focal_length * camera.focal_length)
    pdf_a = 1.0 / aperture_area(camera)
    pdf_v = 1.0 / (camera.film_width * camera.film_height)
    return pdf_v * pdf_a / g


def connect(camera, width: int, height: int, y, r_ap1, r_ap2, time):
    """Connect world vertices ``y`` to sampled aperture points: the LT /
    BDPT camera connection.

    The thin-lens importance is the constant ``sensor`` per (aperture area
    x emitted solid angle), so the splat value of a light-subpath vertex is
    c = T * f(y -> ap) * V * sensor * G(y, ap) / p_ap.

    Returns dict(pix_i, pix_j, ap_pos, dir (y -> aperture, unit), dist,
    cam_n, weight = sensor * aperture_area (the 1/p_ap included; the caller
    multiplies f * G and tests visibility), valid)."""
    a, b, n, x = cam_frame(camera, time)
    lens_radius = 0.5 / camera.f_stop * camera.focal_length
    phi = 2.0 * math.pi * r_ap1
    rad = sqrt(r_ap2) * lens_radius
    u = torch.cos(phi) * rad
    v = torch.sin(phi) * rad
    aoff = u[..., None] * a + v[..., None] * b
    ap = x + aoff

    to_y = y - ap
    dn = torch.sum(to_y * n, dim=-1)        # along the view axis
    valid = dn > 1e-6
    dn_safe = torch.where(valid, dn, 1.0)
    # focal-plane point of the ray ap -> y (aoff is in the lens plane)
    s = camera.focus / dn_safe
    fp = ap + s[..., None] * to_y
    rel = fp - x - camera.focus * n
    alpha = torch.sum(rel * a, dim=-1)
    beta = torch.sum(rel * b, dim=-1)
    f = camera.focus / camera.focal_length
    f_rg = -camera.film_width * f / width
    f_up = -camera.film_height * f / height
    pix_i = alpha / f_rg + 0.5 * width
    pix_j = beta / f_up + 0.5 * height
    valid = valid & (pix_i >= 0) & (pix_i < width) & \
        (pix_j >= 0) & (pix_j < height)

    dist = sqrt(torch.clamp(torch.sum(to_y * to_y, dim=-1), min=1e-20))
    direction = -to_y / dist[..., None]    # y -> aperture
    sensor = SENSOR_RESPONSE * 100.0 * camera.exposure_time
    weight = sensor * aperture_area(camera)   # = sensor / p_ap
    return dict(pix_i=pix_i, pix_j=pix_j, ap_pos=ap, dir=direction,
                dist=dist, cam_n=n, weight=weight, valid=valid)
