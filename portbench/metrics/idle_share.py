"""The device's idle share: 1 - (union of the intervals in which anything
ran on the card, from the trace of the card's activity) / (the same
calls' seconds untraced).  Tracing the card slows the host's launches, so
the traced window's own length would overstate the idle share of a
launch-bound cell."""


def read(ctx):
    if ctx.wall_s <= 0 or ctx.busy_s <= 0:
        return None
    return 1.0 - ctx.busy_s / ctx.wall_s
