"""Device ms a bdpt progression spends under the program's ``bdpt.camera``
spans: the t = 1 camera connections, each with its shadow ray, MIS and
general splat (``samplers/bdpt.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'bdpt.camera')
