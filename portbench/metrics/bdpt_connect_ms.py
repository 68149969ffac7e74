"""Device ms a bdpt progression spends under the program's ``bdpt.connect``
spans: the s = 0 emitter hits and every s >= 1, t >= 2 connection with
its shadow ray and MIS (``samplers/bdpt.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'bdpt.connect')
