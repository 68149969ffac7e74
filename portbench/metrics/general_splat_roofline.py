"""The general splat's share of its byte floor over one progression, in
%: the floor of each ``splat.general`` span of the host pass
(``_splat_bound.floor_ms`` of the call's splats and the film; each call
splats one sample a lane, ``ctx.extra['lanes']``, into the film of
``ctx.extra['pixels']`` pixels) over the device ms under those spans
(``general_splat_ms``)."""

from portbench.metrics._spans import device_ms, spans
from portbench.metrics._splat_bound import floor_ms


def read(ctx):
    ms = device_ms(ctx, 'splat.general')
    lanes, pixels = ctx.extra.get('lanes'), ctx.extra.get('pixels')
    if not ms or not lanes or not pixels:
        return None
    calls = len(spans(ctx, 'splat.general')) / ctx.calls
    return 100.0 * calls * floor_ms(lanes, pixels) / ms
