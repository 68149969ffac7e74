"""The byte floor of the general splat, reckoned from the splats' count
and the film, not from an implementation: each splat's two image
coordinates and three colours read once (20 B), and the framebuffer's
three float32 values a pixel read once and written once (24 B), at the
H100 SXM's 3.35 TB/s (``_roofline.PEAK_BYTES_PER_S``).  A splat's 16
filter taps are computed from its coordinates, so they add no bytes."""

from __future__ import annotations

from portbench.metrics._roofline import PEAK_BYTES_PER_S

SPLAT_BYTES = 4 * (2 + 3)
PIXEL_BYTES = 4 * 3 * 2


def floor_ms(splats: int, pixels: int) -> float:
    """The least ms one general splat of ``splats`` samples into a film of
    ``pixels`` pixels could take."""
    return (splats * SPLAT_BYTES + pixels * PIXEL_BYTES) \
        / PEAK_BYTES_PER_S * 1e3
