"""Of the card's idle time inside the program's ``render.progression``
spans in the host-traced pass, the share that falls while the host is
inside a ``pt.bounce`` span: how much of the waiting the bounce loop's
dispatch leaves, against the camera start, the splat and the readback.
A share within that one pass, whose host the recording slows
(``_spans.py``): an upper figure."""

from portbench.metrics._spans import BOUNCE, idle_share_under


def read(ctx):
    return idle_share_under(ctx, BOUNCE)
