"""Device ms a progression spends under the program's ``pt.splat`` span:
``cie.spectral_to_xyz`` and ``splat.splat_pixel_aligned``."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'pt.splat')
