"""Spans of the solve path, their records and timers, and PyTorch profiler
hooks.

Counterpart of ``kinetica_tpu/utils/profiling.py``, with one recorder
behind the reference's timers and annotations:

* :func:`span` — a named section of host code, used as a context
  manager. While recording is off it is one shared no-op object: no
  clock read, no profiler call. While recording is on it keeps its name,
  start and end (``time.time_ns()``, the clock of the profiler's events,
  so spans lie over a trace's device kernels), its parent span, its
  record and its attributes; inside a ``torch.profiler`` session it also
  enters a profiler record function of the same name, so Chrome traces
  show the solver's phases.
* Recording is decided once, as an outermost span opens (on the solve
  path the entry: ``EnsembleProblem.solve``, ``solve_network``, or
  ``bdf_solve`` / ``rk45_solve`` called directly): it is on while
  :class:`Timings` is enabled (``KINETICA_TPU_TIMINGS=1`` or
  ``Timings.enable()``) or a ``torch.profiler`` session records.
* Each outermost span that records leaves one :class:`Record` (one a
  solve): its spans, the deltas over it of the program's counters
  (:data:`COUNTERS`), and the spans dropped past the store's bound
  (:data:`MAX_RECORDS` records, :data:`MAX_SPANS` spans).
  :func:`last_solve` returns the newest.
* :class:`Timings` aggregates the recorded spans by name (total, count,
  mean and self time); :func:`timed` and :func:`annotate` are
  :func:`span` under the reference's names. Spans read the host clock: on
  a CUDA device a span's time is the host's dispatch of its work plus any
  wait for the device inside it, not the device's own time.
* :func:`trace` — context manager around ``torch.profiler.profile``
  writing a Chrome trace (``chrome://tracing``, Perfetto), with the
  device's kernels when a card is present.

The solve path's host code is single-threaded: the recorder is module
state and takes no lock.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from .logging import logger

MAX_RECORDS = 16
MAX_SPANS = 1_000_000

_PKG = __name__.rsplit(".", 2)[0]
# the program's counters a record holds the deltas of: name -> (module of
# the package, attribute); an int, or a dict of ints by key
COUNTERS = {
    "host_sync.count": ("ops.host_sync", "count"),
    "host_sync.by_site": ("ops.host_sync", "by_site"),
    "bdf.jac_refreshes": ("ops.bdf", "jac_refreshes"),
    "bdf.newton_iters": ("ops.bdf", "newton_iters"),
    "bdf.tail_replays": ("ops.bdf", "tail_replays"),
    "bdf.tail_captures": ("ops.bdf", "tail_captures"),
    "bdf.lane_steps": ("ops.bdf", "lane_steps"),
    "bdf.rejected": ("ops.bdf", "rejected"),
    "linalg.factor_builds": ("ops.linalg", "factor_builds"),
    "linalg.factor_lanes": ("ops.linalg", "factor_lanes"),
    "linalg.refine_sweeps": ("ops.linalg", "refine_sweeps"),
    "linalg.refine_accurate_sweeps": ("ops.linalg", "refine_accurate_sweeps"),
    **{f"{k}.launches": (f"ops.{k}", "launches")
       for k in ("fused_rhs", "dd_contract", "gj_inverse", "newton_solve",
                 "grid_probe")},
}


class Span:
    """One recorded span: ``id`` (unique in its record), ``parent`` (the
    enclosing span's id, -1 for the record's outermost), ``record`` (the
    record's id), ``name``, ``start_ns`` / ``end_ns`` (Unix ns) and
    ``attrs``."""

    __slots__ = ("id", "parent", "record", "name", "start_ns", "end_ns",
                 "attrs", "_child_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0
        self._child_ns = 0
        self._rf = None

    def note(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _held
        rec = _open
        self.id = len(rec.spans) + rec.dropped
        self.parent = _stack[-1].id if _stack else -1
        self.record = rec.id
        rec.spans.append(self)
        _held += 1
        _stack.append(self)
        if _profiled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _stack.pop()
        dur = self.end_ns - self.start_ns
        if _stack:
            _stack[-1]._child_ns += dur
        agg = _totals.get(self.name)
        if agg is None:
            agg = _totals[self.name] = [0, 0, 0]
        agg[0] += dur
        agg[1] += 1
        agg[2] += dur - self._child_ns
        return False


class _NoSpan:
    """The span of a section that does not record."""

    __slots__ = ()

    def note(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Outermost:
    """An outermost span: opens a record if recording is on."""

    __slots__ = ("name", "attrs", "span")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.span = name, attrs, None

    def __enter__(self):
        global _off
        if not (Timings._enabled or _autograd_profiler._is_profiler_enabled):
            _off += 1
            return _NOOP
        _room()
        _begin_record()
        self.span = Span(self.name, self.attrs)
        return self.span.__enter__()

    def __exit__(self, *exc):
        global _off
        if self.span is None:
            _off -= 1
            return False
        self.span.__exit__(*exc)
        _end_record()
        return False


@dataclass
class Record:
    """One outermost span's recording: ``spans`` in start order (the first
    is the outermost), ``counters`` the deltas of :data:`COUNTERS` over it,
    ``dropped`` the spans not kept past :data:`MAX_SPANS`."""
    id: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    dropped: int = 0

    @property
    def top(self) -> Span:
        return self.spans[0]


_store: deque = deque()   # finished records, oldest first
_held = 0                 # spans of the stored records and the open one
_open: Record | None = None
_stack: list = []         # the open record's open spans
_profiled = False         # the open record runs inside a profiler session
_off = 0                  # outermost spans open that do not record
_records = 0
_base: dict = {}          # the counters as the open record began
_totals: dict = {}        # name -> [total ns, count, self ns]


def _read_counters() -> dict:
    out = {}
    for key, (mod, attr) in COUNTERS.items():
        value = getattr(sys.modules.get(f"{_PKG}.{mod}"), attr, 0)
        out[key] = dict(value) if isinstance(value, dict) else value
    return out


def _begin_record() -> None:
    global _open, _profiled, _records, _base
    _records += 1
    _open = Record(id=_records)
    _profiled = _autograd_profiler._is_profiler_enabled
    _base = _read_counters()


def _end_record() -> None:
    global _open, _held
    now = _read_counters()
    for key, value in now.items():
        before = _base[key]
        if isinstance(value, dict):
            before = before if isinstance(before, dict) else {}
            now[key] = {k: v - before.get(k, 0) for k, v in value.items()}
        else:
            now[key] = value - before
    _open.counters = now
    if len(_store) >= MAX_RECORDS:
        _held -= len(_store.popleft().spans)
    _store.append(_open)
    _open = None


def _room() -> bool:
    """Whether one more span fits, after dropping the oldest finished
    records as needed."""
    global _held
    while _held >= MAX_SPANS and _store:
        _held -= len(_store.popleft().spans)
    return _held < MAX_SPANS


def span(name: str, **attrs):
    """A context manager that records the enclosed host code as the span
    ``name`` with ``attrs`` while recording is on (module docstring), and
    does nothing otherwise. ``with span(...) as sp`` gives an object whose
    ``note(**attrs)`` adds attributes."""
    if _open is None:
        return _NOOP if _off else _Outermost(name, attrs)
    if _held >= MAX_SPANS and not _room():
        _open.dropped += 1
        return _NOOP
    return Span(name, attrs)


def spanned(name: str):
    """Decorator: every call of the function is a :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


timed = span
annotate = span


def last_solve() -> Record | None:
    """The newest finished record (one a solve on the solve path), or
    None."""
    return _store[-1] if _store else None


class Timings:
    """The switch of recording by the operator, and the recorded spans'
    times by name."""

    _enabled = bool(os.environ.get("KINETICA_TPU_TIMINGS"))

    @classmethod
    def enable(cls, on: bool = True) -> None:
        cls._enabled = on

    @classmethod
    def enabled(cls) -> bool:
        return cls._enabled

    @classmethod
    def add(cls, name: str, dt: float) -> None:
        """Count a section of ``dt`` seconds timed elsewhere under
        ``name``."""
        agg = _totals.setdefault(name, [0, 0, 0])
        ns = round(dt * 1e9)
        agg[0] += ns
        agg[1] += 1
        agg[2] += ns

    @classmethod
    def reset(cls) -> None:
        _totals.clear()

    @classmethod
    def report(cls, log: bool = True) -> dict[str, dict[str, float]]:
        """Per span name: ``total_s``, ``count``, ``mean_s`` and ``self_s``
        (the total less the time its recorded child spans cover)."""
        out = {k: {"total_s": t * 1e-9, "count": n,
                   "mean_s": t * 1e-9 / max(n, 1), "self_s": s * 1e-9}
               for k, (t, n, s) in sorted(_totals.items())}
        if log and out:
            logger.info("--- kinetica_tpu_torch timings ---")
            for k, v in out.items():
                logger.info("  %-32s %9.3fs total  %9.3fs self  %6d calls  "
                            "%9.4fs mean", k, v["total_s"], v["self_s"],
                            v["count"], v["mean_s"])
        return out


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
