"""Device ms a progression spends under the program's ``splat.general``
spans: ``ops/splat.splat``, the reproducible splat of samples that land
anywhere on the film (two stable sorts, ``searchsorted`` and
``segment_reduce``), which bdpt's t = 1 connections call."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'splat.general')
