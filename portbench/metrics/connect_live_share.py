"""The share of bdpt's dense connection passes that does useful work over
one progression: the lanes still connected after the visibility test over
the lanes of every connection computed (s >= 1), from the program's
counters (``corona13_tpu_torch.tracing.counting``,
``Counters.connect_live_share``).  The harness hands the progression as
``ctx.extra['frame']`` (the first traced call again), which runs once
more inside the block, as ``dead_lane_share`` runs it."""


def read(ctx):
    frame = ctx.extra.get('frame')
    if frame is None:
        return None
    try:
        from corona13_tpu_torch.tracing import counting
    except ImportError:          # a program without counters
        return None
    with counting() as counters:
        frame()
    share = getattr(counters, 'connect_live_share', None)
    return None if share is None else share()
