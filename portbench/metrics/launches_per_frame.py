"""Device events (kernels, copies, sets) a progression launches in the
traced window: the host's launch overhead the bounce wavefront pays
(``samplers/pt.py``, ``models/*``)."""


def read(ctx):
    return ctx.launches / ctx.calls if ctx.calls and ctx.launches else None
