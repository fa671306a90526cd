"""Kernel times on the card, and the least time the card could take.

* :func:`event_ms`: the median of single calls between CUDA events. A
  small launch's time includes the wrapper's host work (about 8 us).
* :func:`graph_ms`: the device-only time of one call: ``n`` calls captured
  in one CUDA graph, the graph replayed between CUDA events, the median
  of the replays divided by ``n``.
* :func:`loop_ms`: ``n`` calls back to back between CUDA events, divided
  by ``n``: for a call that a graph cannot capture (``torch.linalg.inv``
  synchronises inside), where it is the time a caller waits.
* :func:`host_us`: the host time of one call in microseconds: ``n``
  calls enqueued back to back on the host clock, no synchronisation
  between them (what a host-bound loop pays for the call).
* :func:`bound`: the larger of the bytes a function must move over the
  memory rate and its operations over the peak rate of their type, on an
  NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense, outside
  the tensor cores); ``*_work`` give each kernel's bytes and operations
  for its inputs.

Used by ``chip_smoke.py`` and the kernel comparison script; nothing here
runs on import, and every function needs a card.
"""
from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def event_ms(fn, n: int = 25, warm: int = 3) -> float:
    """Median time of one call of ``fn`` in ms (CUDA events, warmed up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, n: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Device-only ms of one call: ``n`` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))


def loop_ms(fn, n: int = 20, reps: int = 7, warm: int = 3) -> float:
    """ms of one call: ``n`` calls back to back between CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def host_us(fn, n: int = 200, reps: int = 5, warm: int = 3) -> float:
    """Median host microseconds of one call of ``fn``, enqueued back to back."""
    import time
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def rhs_work(fused, B):
    """(bytes, f64 flops) of one fused RHS call: u_aug, k and du once, the
    network (slots, CSR rows) once; arity products a rate, 2 a nonzero."""
    nnz = fused.csr.rxn.numel()
    net = fused.slots.numel() * 4 + fused.csr.row_ptr.numel() * 4 + nnz * 12
    return ((B * (fused.ns + 1) + B * fused.nr + B * fused.ns) * 8 + net,
            B * (fused.arity * fused.nr + 2.0 * nnz))


def dd_work(dd, B):
    """(bytes, f64 flops) of one contraction: r and du once, the CSR rows
    once; 2 flops a nonzero."""
    nnz = dd.csr.rxn.numel()
    return ((B * dd.nr + B * dd.ns) * 8 + dd.csr.row_ptr.numel() * 4
            + nnz * 12, B * 2.0 * nnz)


def solve_work(B, n, sweeps=4):
    """(bytes, f32 flops) of one Newton solve: M and J (f32), b, c and dy
    (f64) once; dy = M b and up to ``sweeps`` sweeps of two matvecs. The
    bytes bound it even at the most sweeps, so the bound is exact whatever
    number of sweeps the lanes took."""
    return (2 * B * n * n * 4 + (2 * B * n + B) * 8,
            2.0 * B * n * n * (1 + 2 * sweeps))


def inverse_work(B, n):
    """(bytes, f32 flops) of B inverses of n x n: A read, M written; the
    2 n^3 flops of Gauss-Jordan."""
    return 2 * B * n * n * 4, 2.0 * B * n ** 3
