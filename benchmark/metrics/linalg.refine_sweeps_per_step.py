"""Newton-Schulz sweeps a step: the program's ``linalg.refine_sweeps`` over
the traced solve (cheap and accurate sweeps of the batch, each f32 GEMMs),
over its steps max."""
from benchmark import spans


def read(ctx):
    return spans.per_step(ctx, "linalg.refine_sweeps")
