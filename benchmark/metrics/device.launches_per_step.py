"""Kernel-launch API calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernelEx``) in the traced solve over its
steps max."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.traced is None or not ctx.traced.steps_max:
        return None
    return tr.launches / ctx.traced.steps_max
