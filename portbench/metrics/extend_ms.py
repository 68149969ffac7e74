"""Device ms a progression spends under the program's ``pt.extend``
spans: BSDF or phase sampling, Russian roulette, the interior stack and
the masked state merge (``bsdf.bsdf_sample``, ``samplers/pt.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'pt.extend')
