"""Device ms a progression spends under the program's outermost
``pt.media`` spans: the current medium, free flight, segment emission and
the media pdf terms of each bounce, and the ``pt.media`` spans nested in
NEE (``transmittance_scene``) and in the extension (the interior stack's
push and pop) (``models/medium.py``, ``models/medium_hete.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'pt.media')
