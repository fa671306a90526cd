"""Seconds from the process's start to the window's: imports, the CUDA
context, the inputs, the program's problem, its kernels (built by
``nvcc`` on a checkout's first run, loaded from the build cache after)
and the warm-up of one chunk at the cell's batch."""


def read(ctx):
    return ctx.setup_s
