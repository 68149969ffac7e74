"""Device ms a progression spends in the kernels that ``aten::cumsum``
launches: the grid march's scan (``models/medium_hete.py``) and the
interior stack's scan (``models/medium.py`` ``stack_pop``)."""


def read(ctx):
    us = ctx.device_us_under('aten::cumsum')
    return us * 1e-3 / ctx.calls if ctx.calls and us > 0 else None
