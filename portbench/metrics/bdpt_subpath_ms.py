"""Device ms a bdpt progression spends under the program's ``bdpt.subpath``
spans: the subpaths' starts (camera and emission samples) and each eye
and light bounce, their closest-hit kernels included
(``samplers/bdpt.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'bdpt.subpath')
