"""Accurate Newton-Schulz sweeps a step: the program's
``linalg.refine_accurate_sweeps`` over the traced solve (the batch's
sweeps with an f64 residual and a host read each, which near-singular
factors reach past the cheap f32 ones), over its steps max. A program
without the counter gives no reading."""
from benchmark import spans


def read(ctx):
    return spans.per_step(ctx, "linalg.refine_accurate_sweeps")
