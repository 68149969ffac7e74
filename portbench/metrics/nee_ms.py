"""Device ms a progression spends under the program's ``pt.nee`` spans:
area and envmap next event estimation, their shadow rays' traversal
(``trace.occluded``) included (``models/lights.py``,
``bsdf.bsdf_eval_pdf``, ``samplers/pt.py``)."""

from portbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, 'pt.nee')
