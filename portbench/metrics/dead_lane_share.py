"""The dense wavefront's wasted lanes over one progression: 1 - (lanes
alive at the start of each bounce, summed) / (the wavefront's width at
each bounce, summed), from the program's counters
(``corona13_tpu_torch.tracing.counting``), which count only inside that
block.  The harness hands the progression as ``ctx.extra['frame']`` (the
first traced call again), which runs once more inside the block, as
``trace_roofline`` runs it again."""


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
    return counters.dead_lane_share()
