"""Newton iterations a step: the program's ``bdf.newton_iters`` over the
traced solve (each iteration runs the RHS and the Newton solve on every
lane of the batch), over its steps max."""
from benchmark import spans


def read(ctx):
    return spans.per_step(ctx, "bdf.newton_iters")
