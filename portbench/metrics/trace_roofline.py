"""The traversal kernels' share of their roofline over one progression,
in %: the sum of each launch's bound (``_roofline.launch_bound``: the
larger of its operations over 67 TFLOP/s and its bytes over 3.35 TB/s,
the work counted by the plain skip-link walk on the launch's own rays
and tree) over the sum of their device time in a profile of the same
progression.  The harness hands the progression as ``ctx.extra['frame']``
(the first traced call again), its rays as ``lanes`` and its
``max_verts``."""

from portbench.metrics._capture import capture_calls
from portbench.metrics._kernels import kernel_key
from portbench.metrics._roofline import launch_bound
from portbench.trace import profile_kernels


def read(ctx):
    frame = ctx.extra.get('frame')
    if frame is None:
        return None
    every = range(2 * ctx.extra['max_verts'])
    kept = capture_calls(frame, ctx.extra['lanes'],
                         {'closest_hit': every, 'any_hit': every})
    bound_ms = sum(launch_bound(mode, *call)[0]
                   for mode, calls in kept.items() for call in calls)
    device_us = sum(us for name, us in profile_kernels(frame)
                    if kernel_key(name) is not None)
    if bound_ms <= 0 or device_us <= 0:
        return None
    return 100.0 * bound_ms / (device_us * 1e-3)
