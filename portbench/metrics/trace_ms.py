"""Device ms a progression spends in the traversal kernels
(``traverse_kernel``, ``deep_kernel``, ``skip_kernel``, ``dense_kernel``,
``union_kernel`` of ``csrc/traverse_tris.cu``), named as the frozen
``_kernels.kernel_key`` names them."""

from portbench.metrics._kernels import kernel_key


def read(ctx):
    us = ctx.device_us_where(lambda name: kernel_key(name) is not None)
    return us * 1e-3 / ctx.calls if ctx.calls and us > 0 else None
