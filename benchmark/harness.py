"""One run of one cell: set-up, warm-up, the measured window, the traced
solve, the check, the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``file``), the mix ``traffic/<name>.json``, the
entry ``entries/<entry>.py`` the mix names, the limits
``limits/<workload>.json``, and one reader a metric,
``end_to_end/<name>.py`` or ``metrics/<name>.py``, each with
``read(ctx) -> float | None``. A reader that finds nothing to read
returns None and its metric is left out of the line. A new cell, mix,
configuration or metric is new files and entries; no file here changes.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, network
from . import traffic as traffic_mod

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class SolveRecord:
    wall_s: float
    steps_max: int
    n_steps: np.ndarray
    n_lu: np.ndarray
    host_syncs: int
    attempts: int


@dataclass
class Shape:
    batch: int
    ns: int
    nr: int
    nnz: int
    arity: int


@dataclass
class Context:
    """What the readers read: the window (``profiles``, ``window_s``,
    ``setup_s``, ``solves``), the traced solve (``trace``, and its
    program counters ``traced``) and the cell's shapes."""
    shape: Shape
    setup_s: float = 0.0
    window_s: float = 0.0
    profiles: int = 0
    solves: list[SolveRecord] = field(default_factory=list)
    trace: object = None
    traced: SolveRecord | None = None


class Spec:
    """``BENCHMARK.json`` of a checkout, and its cells by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        path = self.root / "benchmark" / "traffic" / f"{name}.json"
        return json.loads(path.read_text())

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"):
        those that list it, or list no cells and move one of its
        end-to-end metrics."""
        e2e = {m["name"] for m in self.data["end_to_end"]
               if workload in m.get("workloads", [workload])}
        out = []
        for m in self.data[kind]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def module(self, folder: str, name: str):
        """``benchmark/<folder>/<name>.py``, loaded by path."""
        path = self.root / "benchmark" / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def shape_of(net: network.Network, batch: int) -> Shape:
    N = net.stoichiometry()
    return Shape(batch=batch, ns=net.ns, nr=net.nr,
                 nnz=int(np.count_nonzero(N)), arity=2)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, log=print) -> dict:
    """The run's result (every key of the last line) for one cell on
    ``device``. ``t_start`` is the process's start on the host clock."""
    import torch
    from kinetica_tpu_torch.ops import host_sync

    from . import trace as trace_mod

    cell = spec.workload(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = check.load_limits(spec.root, workload)
    net = network.from_config(config)
    ctx = Context(shape=shape_of(net, int(traffic["batch"])))

    t_inputs = time.perf_counter()
    entry = spec.module("entries", traffic["entry"]).make(config, net,
                                                          traffic, device)
    _sync(device)
    t_problem = time.perf_counter()
    entry.warm_up(traffic_mod.Ramps(traffic, seed,
                                    traffic_mod.WARMUP).next_batch())
    _sync(device)
    log(f"set-up: to the inputs {t_inputs - t_start:.3f} s, the problem "
        f"{t_problem - t_inputs:.3f} s, the warm-up "
        f"{time.perf_counter() - t_problem:.3f} s")
    ramps = traffic_mod.Ramps(traffic, seed)
    answers = []

    def solve():
        rates = ramps.next_batch()
        syncs = host_sync.count
        s0 = time.perf_counter()
        out = entry.solve(rates)
        _sync(device)
        rec = SolveRecord(time.perf_counter() - s0, out.steps_max,
                          out.n_steps, out.n_lu, host_sync.count - syncs,
                          out.attempts)
        answers.append((rates, out.u, out.ok, out.n_steps))
        return rec

    w0 = time.perf_counter()
    ctx.setup_s = w0 - t_start
    # no solve starts once ``seconds`` have passed and the groups of the
    # mix's ramps are whole
    while time.perf_counter() - w0 < seconds or not ramps.whole:
        ctx.solves.append(solve())
    ctx.window_s = time.perf_counter() - w0
    ctx.profiles = len(ctx.solves) * ctx.shape.batch
    log(f"window: {len(ctx.solves)} solves, {ctx.profiles} profiles in "
        f"{ctx.window_s:.3f} s; set-up {ctx.setup_s:.3f} s; steps max "
        f"{[s.steps_max for s in ctx.solves]}; seconds "
        f"{[round(s.wall_s, 3) for s in ctx.solves]}")
    if trace:
        rec, ctx.trace = trace_mod.traced(solve, device)
        ctx.traced = rec
        log(f"traced solve: {rec.wall_s:.3f} s, {rec.steps_max} steps max; "
            f"trace {trace_mod.to_json(ctx.trace)}")
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check.compare(config, traffic, answers, seed, limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, kind):
        value = spec.module(kind if kind == "end_to_end" else "metrics",
                            m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": check.passed(checks),
              "attempted": sum(len(a[0]) for a in answers),
              "failed": checks["failed_lanes"]["value"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = checks
    return result
