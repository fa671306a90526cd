"""One solve under ``torch.profiler``, reduced to what the metrics read.

The traced window is one whole solve, inside a ``benchmark.traced_solve``
span that ends after ``torch.cuda.synchronize()``. From the profiler's own
events (no Chrome trace is written) it keeps:

* ``kernels``: every device kernel in the window as (name, start ns,
  duration ns);
* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
* ``launches``: the kernel-launch API calls in the window;
* ``device_ops`` and ``idle_gaps`` for ``breakdown``: device time by
  operation, and the device's idle time by the host operation open when
  each gap began (the innermost operation or runtime call, "host (no op
  open)" between operations).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

SPAN = "benchmark.traced_solve"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_KINDS = ("user_annotation", "gpu_user_annotation")


@dataclass
class Kernel:
    name: str
    start_ns: int
    dur_ns: int


@dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    kernels: list[Kernel] = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    host_reduce_s: float = 0.0
    n_events: int = 0


def short_name(name: str) -> str:
    """A kernel's name without namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:120]


def traced(fn, device):
    """``(fn(), Trace)``: ``fn`` run once under the profiler (CPU and, on a
    card, CUDA activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            out = fn()
            if cuda:
                torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    tr = reduce(events)
    tr.n_events = len(events)
    tr.host_reduce_s = time.perf_counter() - t0
    return out, tr


def _kind(e) -> str:
    """The event's kineto activity: "kernel", "gpu_memcpy", "gpu_memset",
    "gpu_user_annotation" on the device; "host" for an operation or a
    runtime call on the host, "user_annotation" for a span. Read from the
    event where torch exposes it, else from its device and name."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return kind if kind in DEVICE_KINDS + SPAN_KINDS else "host"
    on_device = str(e.device_type()).endswith("CUDA")
    if e.name() == SPAN:
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "host"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce(events) -> Trace:
    """The window's numbers from the profiler's events."""
    span = next((e for e in events if e.name() == SPAN
                 and _kind(e) == "user_annotation"), None)
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN} span")
    lo = span.start_ns()
    hi = lo + span.duration_ns()
    kernels, device, host = [], [], []
    launches = 0
    by_op: dict[str, int] = {}
    for e in events:
        start = e.start_ns()
        if start < lo or start > hi:
            continue
        kind = _kind(e)
        dur = e.duration_ns()
        if kind in DEVICE_KINDS:
            name = e.name()
            device.append((start, start + dur))
            key = short_name(name) if kind == "kernel" else kind
            by_op[key] = by_op.get(key, 0) + dur
            if kind == "kernel":
                kernels.append(Kernel(name, start, dur))
        elif kind == "host":
            name = e.name()
            if name in LAUNCH_CALLS:
                launches += 1
            host.append((start, start + dur, name))
    busy, gaps = _union_and_gaps(device, lo, hi)
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                 launches=launches, kernels=kernels,
                 device_ops=_top(by_op), idle_gaps=_top(_label(gaps, host)))


def _union_and_gaps(intervals, lo, hi):
    """(covered ns, [(gap start, gap end)]) of ``intervals`` in [lo, hi]."""
    intervals.sort()
    busy, gaps, cur = 0, [], lo
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= cur:
            continue
        if a > cur:
            gaps.append((cur, a))
            cur = a
        busy += b - cur
        cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _label(gaps, host) -> dict[str, int]:
    """Idle ns by the innermost host operation open at each gap's start."""
    host.sort()
    out: dict[str, int] = {}
    open_ops: list = []      # (end, start, name), scanned in start order
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] <= g0:
            open_ops.append((host[i][1], host[i][0], host[i][2]))
            i += 1
        open_ops = [o for o in open_ops if o[0] > g0]
        name = (max(open_ops, key=lambda o: o[1])[2] if open_ops
                else "host (no op open)")
        out[name] = out.get(name, 0) + (g1 - g0)
    return out


def _top(ns_by_name: dict[str, int], n: int = 10) -> list:
    top = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in top]


def to_json(tr: Trace) -> str:
    """The trace's summary (not its kernels) as one JSON line."""
    return json.dumps({"window_s": tr.window_s, "busy_s": tr.busy_s,
                       "launches": tr.launches, "kernels": len(tr.kernels),
                       "device_ops": tr.device_ops,
                       "idle_gaps": tr.idle_gaps,
                       "host_reduce_s": tr.host_reduce_s,
                       "n_events": tr.n_events})
