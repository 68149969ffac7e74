"""Scene tables on the device (corona13_tpu/scene.py).

Every scene material is one row of a SoA material table; spectral albedos
are fitted to sigmoid-polynomial coefficients at load.  ``load_scene``
(the .nra2 front end) is not ported yet: scenes come from ``testing`` or
from ``convert.scene_from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .io import cam as cam_io
from .models.bsdf import DIELECTRIC, DIFFDIEL, DIFFUSE, HAIR, METAL, NULL  # noqa: F401
from .ops.trace import DeviceGeometry
from .spectral import rgb2spec

# sky kinds
SKY_BLACK = 0
SKY_CONST = 1
SKY_CLOUDY = 2
SKY_ENVMAP = 3
SKY_DAYLIGHT = 4


@dataclasses.dataclass
class MaterialTable:
    """SoA of resolved materials; one row per scene shader id."""
    kind: torch.Tensor          # [M] int64 host bsdf
    d_coeff: torch.Tensor       # [M, 3] sigmoid coeffs for diffuse albedo
    d_mul: torch.Tensor         # [M]
    g_coeff: torch.Tensor       # [M, 3] glossy
    g_mul: torch.Tensor         # [M]
    e_coeff: torch.Tensor       # [M, 3] emission
    e_mul: torch.Tensor         # [M]
    roughness: torch.Tensor     # [M]
    ior_nd: torch.Tensor        # [M] dielectric n_d
    ior_abbe: torch.Tensor      # [M] dielectric Abbe number
    use_checker: torch.Tensor   # [M] bool: diffuse albedo from the IT8 chart
    checker_spectra: torch.Tensor  # [140, 36] measured patch reflectances
    med_mut_coeff: torch.Tensor  # [M, 3]
    med_mut_mul: torch.Tensor   # [M]
    med_mus_coeff: torch.Tensor  # [M, 3]
    med_mus_mul: torch.Tensor   # [M]
    med_g: torch.Tensor         # [M] HG mean cosine
    med_enabled: torch.Tensor   # [M] bool
    tex_idx: torch.Tensor       # [M] int64 (-1 = none)
    tex_slot: torch.Tensor      # [M] int64: 0=d 1=g 2=e
    tex_mul: torch.Tensor       # [M]
    fres_n: torch.Tensor        # [M, 7]
    fres_k: torch.Tensor        # [M, 7]


@dataclasses.dataclass
class LightTable:
    """Flat emitter CDF over prims, area*L weighted."""
    prim: torch.Tensor         # [K] int64 global prim id of each light prim
    cdf: torch.Tensor          # [K] inclusive normalized CDF
    weight: torch.Tensor       # [K] L / sum(L*A): NEE area pdf of each prim
    area: torch.Tensor         # [K] prim area
    prim_weight: torch.Tensor  # [P] global prim -> light weight (0 if none)

    @property
    def n_lights(self):
        return self.prim.shape[0]


@dataclasses.dataclass
class CameraP:
    """Device camera (thin-lens parameters as 0-d float32 tensors)."""
    pos: torch.Tensor
    pos_t1: torch.Tensor
    orient: torch.Tensor
    orient_t1: torch.Tensor
    focus: torch.Tensor
    focal_length: torch.Tensor
    film_width: torch.Tensor
    film_height: torch.Tensor
    f_stop: torch.Tensor
    exposure_time: torch.Tensor
    iso: torch.Tensor
    crop_factor: torch.Tensor | None = None


@dataclasses.dataclass
class Scene:
    geom: DeviceGeometry
    materials: MaterialTable
    lights: LightTable
    camera: CameraP
    prim_shader: torch.Tensor   # [P] int64 global prim -> material id
    sky_kind: torch.Tensor      # 0-d int64
    sky_coeff: torch.Tensor     # [3] emission spectrum coeffs (const sky)
    sky_mul: torch.Tensor       # 0-d
    # BSDF kinds present: absent branches are skipped
    kinds_used: tuple = (0, 1, 2)
    has_envmap: bool = False
    has_daylight: bool = False
    has_hete: bool = False
    has_vol_emission: bool = False
    exterior_med: int = -1
    has_textures: bool = False

    @property
    def device(self):
        return self.prim_shader.device


@dataclasses.dataclass
class _ResolvedMat:
    kind: int = DIFFUSE
    d_rgb: tuple = (0.0, 0.0, 0.0)
    g_rgb: tuple = (0.0, 0.0, 0.0)
    e_rgb: tuple = (0.0, 0.0, 0.0)
    roughness: float = 1.0
    ior_nd: float = 1.5
    ior_abbe: float = 50.0
    use_checker: bool = False
    med_mfp_rgb: tuple = (0.0, 0.0, 0.0)
    med_albedo_rgb: tuple = (0.0, 0.0, 0.0)
    med_g: float = 0.0
    med_enabled: bool = False
    emissive_L: float = 0.0
    hete_file: str = ''
    hete_params: tuple = ()
    tex_file: str = ''
    tex_slot: int = 0
    tex_mul: float = 1.0
    metal_name: str = 'default'


def _fit(rgbs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    coeff, mul = rgb2spec.fit_coeff_scaled(rgbs, space='ergb')
    # exact zero for black inputs (the sigmoid floor is ~1e-3, which would
    # otherwise make every surface an emitter in the light CDF)
    mul = np.where(rgbs.max(axis=-1) <= 0.0, 0.0, mul)
    return coeff.astype(np.float32), mul.astype(np.float32)


def fit_film(scene: Scene, width: int, height: int) -> Scene:
    """Refit the camera film back to the render aspect: the 35mm back
    scaled by 1/crop_factor, the other side following the pixel aspect
    (the reference's view_cam_read)."""
    cam = scene.camera
    f32 = dict(dtype=torch.float32, device=cam.focus.device)
    crop = (cam.crop_factor if cam.crop_factor is not None
            else torch.tensor(1.0, **f32))
    full = torch.tensor(cam_io.FULL_FRAME_WIDTH, **f32) / crop
    if width > height:
        fw = full
        fh = full * (height / width)
    else:
        fh = full
        fw = full * (width / height)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        cam, film_width=fw, film_height=fh))
