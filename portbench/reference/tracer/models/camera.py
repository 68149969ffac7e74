# Frozen copy of corona13_tpu_torch/models/camera.py (lines 1-127) as of commit 2084081, for the benchmark's plain reference.
"""Thin-lens camera model (corona13_tpu/models/camera.py).

camera_sample returns throughput = sensor * G / (pdf_aperture * pdf_film)
with the v1 pdf in projected solid angle, like the reference thinlens.c.
"""

from __future__ import annotations

import math

import torch

from ..utils.math import normalize, quat_rotate, quat_slerp, sqrt

SENSOR_RESPONSE = 106.86535  # X+Y+Z=1 -> visible scale (thinlens.c:28)


def cam_frame(camera, time):
    """Camera basis at shutter time: right (a), up (b), view (n), position."""
    t = torch.as_tensor(time)[..., None]
    q = quat_slerp(camera.orient, camera.orient_t1, t)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    shape = q.shape[:-1] + (3,)
    a = normalize(quat_rotate(q, eye[0].expand(shape)))
    b = normalize(quat_rotate(q, eye[1].expand(shape)))
    n = normalize(quat_rotate(q, eye[2].expand(shape)))
    x = camera.pos * (1.0 - t) + camera.pos_t1 * t
    return a, b, n, x


def aperture_area(camera):
    f = camera.focal_length
    n = camera.f_stop
    return math.pi * f * f / (4.0 * n * n)


def sample(camera, width: int, height: int, pix_i, pix_j, r_ap1, r_ap2, time):
    """Primary rays for pixels (pix_i, pix_j) (continuous coords).

    Returns (org, dir, throughput, pdf_proj), pdf in projected solid angle."""
    a, b, n, x = cam_frame(camera, time)
    lens_radius = 0.5 / camera.f_stop * camera.focal_length
    phi = 2.0 * math.pi * r_ap1
    rad = sqrt(r_ap2) * lens_radius
    u = torch.cos(phi) * rad
    v = torch.sin(phi) * rad

    f = camera.focus / camera.focal_length
    f_dir = camera.focus
    f_rg = -camera.film_width * f / width
    f_up = -camera.film_height * f / height

    aoff = u[..., None] * a + v[..., None] * b
    d = (f_dir * n
         + ((pix_i - 0.5 * width) * f_rg)[..., None] * a
         + ((pix_j - 0.5 * height) * f_up)[..., None] * b
         - aoff)
    d = normalize(d)
    org = x + aoff

    area = aperture_area(camera)
    pdf_a = 1.0 / area
    sensor = SENSOR_RESPONSE * 100.0 * camera.exposure_time
    cos_t = torch.sum(d * n, dim=-1)
    g = cos_t ** 4 / (camera.focal_length * camera.focal_length)
    pdf_v = 1.0 / (camera.film_width * camera.film_height)
    pdf_proj = pdf_v * pdf_a / g
    throughput = sensor * g / (pdf_a * pdf_v)
    return org, d, throughput, pdf_proj

