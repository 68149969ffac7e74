# Frozen copy of corona13_tpu_torch/io/cam.py (lines 1-112) as of commit 2084081, for the benchmark's plain reference.
"""Reader and writer for the reference's binary ``.cam`` camera files
(corona13_tpu/io/cam.py).

Both the v1 'CCAM' layout and the legacy v0 struct dump, told apart by
file size as the reference's camera_read does (corona-13
include/camera.h:101-196).  Quaternions are stored (w, x, y, z).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# photographic parameter tables (reference src/view.c:71-80)
F_STOP = np.array([0.5, 0.7, 1.0, 1.4, 2, 2.8, 4, 5.6, 8, 11, 16, 22, 32,
                   45, 64, 90, 128], np.float32)
EXPOSURE_TIME = np.array([60.0, 30.0, 15.0, 8.0, 4.0, 2.0, 1.0, 0.5, 1 / 4,
                          1 / 8, 1 / 15, 1 / 30, 1 / 60, 1 / 125, 1 / 250,
                          1 / 500, 1 / 1000, 1 / 2000, 1 / 4000, 1 / 8000],
                         np.float32)
FULL_FRAME_WIDTH = 0.35  # 35mm film back in the scene's mm-units (view.c:70)

_V1_FMT = '<4si 3f3f 4f4f f f f f f f i i f f'
_V0_FMT = '<i 3f 4f f 7i f 4f 3f f 4f f f f f f i f f i'
_V1_SIZE = struct.calcsize(_V1_FMT)
_V0_SIZE = struct.calcsize(_V0_FMT)


@dataclasses.dataclass
class CameraData:
    """Host-side camera description (the device tensors are built in
    testing.assemble_scene)."""
    pos: np.ndarray            # [3] world position, shutter open
    pos_t1: np.ndarray         # [3] shutter close
    orient: np.ndarray         # [4] quaternion (w, x, y, z)
    orient_t1: np.ndarray      # [4]
    focus: float = 10.0        # focus distance [dm]
    focal_length: float = 0.35 # [scene mm-units]
    film_width: float = 0.36
    film_height: float = 0.2025
    crop_factor: float = 1.0
    aperture_value: int = 6    # index into F_STOP
    exposure_value: int = 11   # index into EXPOSURE_TIME
    iso: float = 100.0
    speed: float = 0.5
    focus_sensor_offset: float = 0.0

    @property
    def f_stop(self) -> float:
        return float(F_STOP[self.aperture_value])

    @property
    def exposure_time(self) -> float:
        return float(EXPOSURE_TIME[self.exposure_value])


def read_cam(path: str) -> CameraData:
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) == _V0_SIZE and data[:4] != b'CCAM':
        v = struct.unpack(_V0_FMT, data)
        return CameraData(
            pos=np.array(v[1:4], np.float32),
            orient=np.array(v[4:8], np.float32),
            speed=v[8],
            iso=v[16],
            orient_t1=np.array(v[17:21], np.float32),
            pos_t1=np.array(v[21:24], np.float32),
            focus_sensor_offset=v[24],
            focus=v[29],
            crop_factor=v[31],
            film_width=v[32],
            film_height=v[33],
            aperture_value=v[34],
            focal_length=v[35],
            exposure_value=v[37],
        )
    if len(data) == _V1_SIZE:
        v = struct.unpack(_V1_FMT, data)
        if v[0] != b'CCAM' or v[1] != 1:
            raise ValueError(f'{path}: bad magic/version')
        return CameraData(
            pos=np.array(v[2:5], np.float32),
            pos_t1=np.array(v[5:8], np.float32),
            orient=np.array(v[8:12], np.float32),
            orient_t1=np.array(v[12:16], np.float32),
            speed=v[16],
            focus_sensor_offset=v[17],
            focus=v[18],
            film_width=v[19],
            film_height=v[20],
            crop_factor=v[21],
            aperture_value=v[22],
            exposure_value=v[23],
            focal_length=v[24],
            iso=v[25],
        )
    raise ValueError(f'{path}: unrecognized camera file size {len(data)}')

