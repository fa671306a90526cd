"""Share of its roofline of the mass-action right-hand side, in %.

Work: ``roofline.rhs_work`` (f64) of each call at the lanes it processed
and the network's shapes, summed; over the device time of the kernels
named in ``KERNELS`` in the traced solve. Every call takes the solve's
whole batch (``ops/bdf.py`` computes all lanes each step), so a call's
lanes are the cell's batch; a traced solve that retried failed lanes in a
smaller batch gives no reading. The profiler's events carry no launch
grid on the card's torch (2.11), so the lanes are not read from it.
"""
from benchmark.roofline import bound_s, rhs_work
from benchmark.trace import short_name

KERNELS = ("fused_rhs_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.traced is None or ctx.traced.attempts != 1:
        return None
    calls = [k for k in ctx.trace.kernels if short_name(k.name) in KERNELS]
    if not calls:
        return None
    sh = ctx.shape
    work = len(calls) * bound_s(*rhs_work(sh.batch, sh.ns, sh.nr, sh.arity,
                                          sh.nnz), "f64")
    return 100.0 * work / (sum(k.dur_ns for k in calls) * 1e-9)
