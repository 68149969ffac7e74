"""Device ms a progression spends under the program's ``pt.shade`` spans:
``shading.prepare``, the geometric term, the emitter and sky hit with its
hero MIS and the pdf product (``samplers/pt.py``, ``models/shading.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'pt.shade')
