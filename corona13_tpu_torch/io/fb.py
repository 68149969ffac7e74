"""File-backed framebuffers (corona13_tpu/io/fb.py) — the reference's
crash-safe progressive render state and checkpoint format
(corona-13 include/framebuffer.h:19-37:
header {magic, width, height, channels, flags, gain} + float32 data,
mmap-shared so re-opening resumes accumulation).

The renderer accumulates on the device and flushes to the file per
render; re-opening an existing .fb resumes at the recorded
sample count (the header gain field stores iso/(100*spp) like
view.c:651-657, so the file is also directly displayable).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

MAGIC = 0x66623133  # 'fb13'
_HDR = '<IiiiIf'    # magic, width, height, channels, overlays(spp), gain
_HDR_SIZE = struct.calcsize(_HDR)


@dataclasses.dataclass
class Framebuffer:
    path: str
    width: int
    height: int
    channels: int = 3
    spp: int = 0          # accumulated progressions ('overlays')
    gain: float = 1.0
    data: np.ndarray | None = None  # [H, W, C] float32 accumulation sums

    @classmethod
    def open(cls, path: str, width: int, height: int, channels: int = 3,
             retain: bool = True) -> 'Framebuffer':
        """Open or create; an existing compatible file resumes accumulation
        (like --retain-framebuffer, view.c:287)."""
        if retain and os.path.exists(path):
            fb = cls.load(path)
            if fb.width == width and fb.height == height and \
                    fb.channels == channels:
                return fb
        return cls(path=path, width=width, height=height, channels=channels,
                   data=np.zeros((height, width, channels), np.float32))

    @classmethod
    def load(cls, path: str) -> 'Framebuffer':
        with open(path, 'rb') as f:
            hdr = f.read(_HDR_SIZE)
            magic, w, h, c, spp, gain = struct.unpack(_HDR, hdr)
            if magic != MAGIC:
                raise ValueError(f'{path}: not a corona13_tpu .fb file')
            data = np.frombuffer(f.read(4 * w * h * c), np.float32)
        return cls(path=path, width=w, height=h, channels=c, spp=spp,
                   gain=gain, data=data.reshape(h, w, c).copy())

    def accumulate(self, splats: np.ndarray, spp: int) -> None:
        """Add ``spp`` progressions worth of unnormalized splat sums."""
        self.data = self.data + np.asarray(splats, np.float32)
        self.spp += spp

    def flush(self, iso: float = 100.0) -> None:
        """Write atomically (temp + rename): a crash mid-flush never
        corrupts the checkpoint."""
        self.gain = iso / (100.0 * max(self.spp, 1))
        tmp = self.path + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(struct.pack(_HDR, MAGIC, self.width, self.height,
                                self.channels, self.spp, self.gain))
            f.write(self.data.astype('<f4').tobytes())
        os.replace(tmp, self.path)

    @property
    def image(self) -> np.ndarray:
        """Normalized image (sum * gain)."""
        return self.data * self.gain
