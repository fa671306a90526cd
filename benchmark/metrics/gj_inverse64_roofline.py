"""Share of its roofline of the Newton factor's f64 Gauss-Jordan inverse
(``gj_inverse64_kernel``), in %.

As ``gj_inverse_roofline`` (its blocks, lanes and Schur split), with the
work of an f64 inverse: ``roofline.inverse_work``'s bytes doubled (A read
and M written in f64) and its 2 n^3 flops at the f64 peak. The Schur
composition's coupling products are cuBLAS GEMMs, neither counted nor
timed here. A traced solve that retried failed lanes, or a program
without the kernel, gives no reading.
"""
from benchmark.metrics.gj_inverse_roofline import blocks
from benchmark.roofline import bound_s, inverse_work
from benchmark.trace import short_name

KERNELS = ("gj_inverse64_kernel",)


def work_s(n: int) -> float:
    """The least seconds of one lane's f64 inverse of n x n."""
    total = 0.0
    for b in blocks(n):
        nbytes, flops = inverse_work(1, b)
        total += bound_s(2 * nbytes, flops, "f64")
    return total


def read(ctx):
    if ctx.trace is None or ctx.traced is None or ctx.traced.attempts != 1:
        return None
    calls = [k for k in ctx.trace.kernels if short_name(k.name) in KERNELS]
    lanes = int(ctx.traced.n_lu.sum())
    if not calls or not lanes:
        return None
    return 100.0 * lanes * work_s(ctx.shape.ns) / (sum(k.dur_ns for k in calls)
                                                    * 1e-9)
