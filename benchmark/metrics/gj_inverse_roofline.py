"""Share of its roofline of the Newton factor's f32 Gauss-Jordan inverse,
in %.

Work: ``roofline.inverse_work`` (f32) of the diagonal blocks that the
factor sends to Gauss-Jordan (``BLOCKS``: one n x n block up to 128
species; above it the block-Schur split of ``ops/gj_inverse.py`` at
commit 55f0abe3ef2893a2eb2dbb1a91147263e5f51748, frozen here: 181 ->
128 + 53), for every lane factor the traced solve built (the sum of the
program's per-lane ``n_lu``; the factor is rebuilt only on the lanes that
need it), over the device time of the kernels named in ``KERNELS`` in the
traced solve. The Schur composition's coupling products are cuBLAS
GEMMs, neither counted nor timed here. A traced solve that retried failed
lanes gives no reading.
"""
from benchmark.roofline import bound_s, inverse_work
from benchmark.trace import short_name

KERNELS = ("gj_inverse_kernel",)
TILE = 128


def blocks(n: int) -> list[int]:
    """The widths of the diagonal blocks an n x n factor's inverse sends to
    Gauss-Jordan."""
    if n <= TILE:
        return [n]
    n1 = TILE * max(1, (n // 2) // TILE)
    return blocks(n1) + blocks(n - n1)


def read(ctx):
    if ctx.trace is None or ctx.traced is None or ctx.traced.attempts != 1:
        return None
    calls = [k for k in ctx.trace.kernels if short_name(k.name) in KERNELS]
    lanes = int(ctx.traced.n_lu.sum())
    if not calls or not lanes:
        return None
    work = lanes * sum(bound_s(*inverse_work(1, b), "f32")
                       for b in blocks(ctx.shape.ns))
    return 100.0 * work / (sum(k.dur_ns for k in calls) * 1e-9)
