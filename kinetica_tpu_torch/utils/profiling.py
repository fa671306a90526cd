"""Lightweight timers and PyTorch profiler hooks.

Counterpart of ``kinetica_tpu/utils/profiling.py``:

* :class:`Timings` / :func:`timed` — nestable wall-clock section timers
  with an aggregated report (host-side; ns overhead when disabled). They
  read the host clock: on a CUDA device a section's time is the host's
  dispatch of its work plus any wait for the device inside it, not the
  device's own time (the reference's ``timed`` measures the same thing
  on its asynchronous TPU dispatch).
* :func:`trace` — context manager around ``torch.profiler.profile``
  writing a Chrome trace (``chrome://tracing``, Perfetto), with the
  device's kernels when a card is present.
* :func:`annotate` — ``torch.profiler.record_function`` so solver phases
  show up as named spans inside a trace.

Enable timers globally with ``KINETICA_TPU_TIMINGS=1`` or per-scope via
``Timings.enable()``.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

from .logging import logger


class Timings:
    """Aggregated named wall-clock sections (thread-unsafe by design: the
    solve orchestration is single-threaded host code)."""

    _enabled = bool(os.environ.get("KINETICA_TPU_TIMINGS"))
    _totals: dict[str, float] = defaultdict(float)
    _counts: dict[str, int] = defaultdict(int)

    @classmethod
    def enable(cls, on: bool = True) -> None:
        cls._enabled = on

    @classmethod
    def enabled(cls) -> bool:
        return cls._enabled

    @classmethod
    def add(cls, name: str, dt: float) -> None:
        cls._totals[name] += dt
        cls._counts[name] += 1

    @classmethod
    def reset(cls) -> None:
        cls._totals.clear()
        cls._counts.clear()

    @classmethod
    def report(cls, log: bool = True) -> dict[str, dict[str, float]]:
        out = {k: {"total_s": cls._totals[k], "count": cls._counts[k],
                   "mean_s": cls._totals[k] / max(cls._counts[k], 1)}
               for k in sorted(cls._totals)}
        if log and out:
            logger.info("--- kinetica_tpu_torch timings ---")
            for k, v in out.items():
                logger.info("  %-32s %9.3fs total  %6d calls  %9.4fs mean",
                            k, v["total_s"], v["count"], v["mean_s"])
        return out


@contextlib.contextmanager
def timed(name: str):
    """Time a section's host wall time into :class:`Timings` (no-op when
    disabled)."""
    if not Timings.enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        Timings.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a profile (``torch.profiler.record_function``)."""
    import torch.profiler
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(logdir: str, with_host: bool = True):
    """Profile the enclosed work into a Chrome trace under ``logdir``.

    The host's activity is recorded with ``with_host`` (always, where there
    is no card), the card's kernels and copies whenever a card is present.
    Yields the path of the trace file it will write::

        with trace("/tmp/kinetica-trace") as path:
            res = solve_network(method, sd, rd)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if with_host or not activities:
        activities.append(ProfilerActivity.CPU)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"kinetica_trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("torch profiler trace written to %s", path)
