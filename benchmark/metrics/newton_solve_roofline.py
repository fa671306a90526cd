"""Share of its roofline of the fused Newton solve, in %.

Work: ``roofline.solve_work`` (f32, up to 4 refinement sweeps; the bytes
bound it at any sweep count) of each call at the cell's batch, summed;
over the device time of the kernels named in ``KERNELS`` in the traced
solve. Every call solves the whole batch of the step (``ops/bdf.py``
computes all lanes each step); a traced solve that retried failed lanes
gives no reading.
"""
from benchmark.roofline import bound_s, solve_work
from benchmark.trace import short_name

KERNELS = ("newton_solve_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.traced is None or ctx.traced.attempts != 1:
        return None
    calls = [k for k in ctx.trace.kernels if short_name(k.name) in KERNELS]
    if not calls:
        return None
    work = len(calls) * bound_s(*solve_work(ctx.shape.batch, ctx.shape.ns),
                                "f32")
    return 100.0 * work / (sum(k.dur_ns for k in calls) * 1e-9)
