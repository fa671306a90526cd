"""The port's benchmark: ``bench.py``'s continuous-rate sweep on the card.

    python -m kinetica_tpu_torch.scripts.bench [--device cuda] [--repeats 3]

The solve of the JAX package's ``bench.py`` (its ``build()`` unchanged):
``synthetic_pyrolysis_network(24)`` (1095 reactions, 73 species) under
B = 64 ``LinearGradientProfile`` ramps at 40-60 K/s from 500 K, tf = 14 s
in chunks of 0.5 s, ``PrecalculatedArrheniusCalculator(k_max=1e12)``,
rtol 1e-8 / atol 1e-10, ``low_k_cutoff="none"``, ``lu_drift_tol`` 0.3,
lazy J, through ``EnsembleProblem(rate_mode="continuous")`` in async
chunks. Its settings keep ``bench.py``'s names and defaults:
``KINETICA_BENCH_NC`` (24), ``KINETICA_BENCH_BATCH`` (64),
``KINETICA_BENCH_LINSOLVE`` ("auto"), ``KINETICA_BENCH_JAC_POLICY``
("lazy"), ``KINETICA_BENCH_LU_DRIFT`` (0.3) and
``KINETICA_BENCH_CHUNK_MODE`` ("auto"; any mode but "auto" or "async"
raises, as ``EnsembleProblem`` does).

The CPU baseline is one profile (member 0) through the pure-numpy
scipy-BDF of :mod:`kinetica_tpu_torch.testing.cpu_reference`, best of 3;
where the global-time solve underflows its step, the chunkwise-local-time
form over the same chunks. It is the reference the sweep is held to, not a
place to run the sweep.

Timing: the first call builds the kernels (``nvcc``, cached under
``kinetica_tpu_torch/_build``) and warms up; ``compile_s`` is its wall
time less the median timed sweep. Then the sweep is timed ``--repeats``
times on the host clock up to ``torch.cuda.synchronize()``; the reported
time is the median, with the minimum and the maximum beside it.

Gate: the final state of member 0 must lie within 1e-6 of scipy-BDF in
max mole fraction (``PERF.md`` section 2), or the program raises and
exits non-zero.

Prints one JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline`` and ``extra``: ``crn``, ``batch``,
``platform``, ``per_profile_ms``, ``cpu_baseline_s``,
``max_molefrac_err``, ``steps_max``, ``steps_median``, ``ms_per_step``,
``chunk_mode``), and in ``extra`` also ``compile_s``, ``repeats``,
``sweep_s`` (every repeat), ``per_profile_ms_min`` / ``_max`` and
``device`` (``nvidia-smi``'s name and power limit on the card). It writes
no file.

It runs on the card unless ``--device cpu`` is given; a CUDA device on a
machine without one raises. Left out of ``bench.py`` on purpose: the
backend probe-and-retry loop, the retried device subprocess and the
fallback to the CPU platform (``bench.py:60-93,239-300``), which would hide
a missing or failing device; ``KINETICA_BENCH_SHARDED``, a check of the
TPU's Mosaic compile (the sharded ensemble is ``chip_smoke.py`` phase 19);
and the JAX compilation cache settings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..examples import device_label

N_CARBONS, BATCH, TF, CHUNK = 24, 64, 14.0, 0.5
RTOL, ATOL, K_MAX = 1e-8, 1e-10, 1e12
GATE = 1e-6
METRIC = "pyrolysis_crn_variable_T_solve_per_profile_speedup"

# the JAX side's record files: the port's programs never write there
JAX_RECORDS = Path(__file__).resolve().parents[2] / "scripts"


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def settings() -> dict:
    """``bench.py``'s environment settings, read at the call."""
    env = os.environ.get
    return {"n_carbons": int(env("KINETICA_BENCH_NC", str(N_CARBONS))),
            "batch": int(env("KINETICA_BENCH_BATCH", str(BATCH))),
            "linsolve": env("KINETICA_BENCH_LINSOLVE", "auto"),
            "jac_policy": env("KINETICA_BENCH_JAC_POLICY", "lazy"),
            "lu_drift_tol": float(env("KINETICA_BENCH_LU_DRIFT", "0.3")),
            "chunk_mode": env("KINETICA_BENCH_CHUNK_MODE", "auto")}


def build(device, batch: int | None = None, tf: float = TF,
          ramp=(40.0, 60.0), chunkstep: float = CHUNK, **pars_kw):
    """``bench.py``'s ``build()``: ``(sd, rd, calc, conditions_list,
    pars)``. The B sweep and the long horizon are cells of the same solve:
    ``batch``, ``tf``, the ramp rates (K/s), ``chunkstep`` and
    ``ODESimulationParams`` keywords change it."""
    from ..calculators.builtin import PrecalculatedArrheniusCalculator
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import LinearGradientProfile
    from ..solving.params import ODESimulationParams
    from ..testing.synthetic import synthetic_pyrolysis_network

    s = settings()
    nc = s["n_carbons"]
    batch = s["batch"] if batch is None else batch
    sd, rd, Ea, A = synthetic_pyrolysis_network(nc)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=device)
    conditions_list = [
        ConditionSet({"T": LinearGradientProfile(
            rate=float(r), X_start=500.0, X_end=500.0 + float(r) * tf)})
        for r in np.linspace(ramp[0], ramp[1], batch)]
    kw = dict(low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
              linsolve=s["linsolve"], jac_policy=s["jac_policy"],
              lu_drift_tol=s["lu_drift_tol"])
    kw.update(pars_kw)
    pars = ODESimulationParams(tspan=(0.0, tf), u0={f"C{nc}": 1.0},
                               solve_chunks=True, solve_chunkstep=chunkstep,
                               **kw)
    return sd, rd, calc, conditions_list, pars


def ensemble(sd, rd, calc, conditions_list, pars, device):
    """The sweep's ``EnsembleProblem`` (continuous rates, the chunk mode of
    ``KINETICA_BENCH_CHUNK_MODE``)."""
    from ..parallel.batching import EnsembleProblem
    from ..solving.methods import VariableODESolve
    return EnsembleProblem(VariableODESolve(pars, conditions_list[0], calc),
                           sd, rd, rate_mode="continuous",
                           chunk_mode=settings()["chunk_mode"], device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_sweeps(problem, conditions_list, device, repeats: int):
    """The first call (builds and warm-up), then ``repeats`` timed sweeps
    -> ``(ens, first_s, [sweep_s, ...])``; raises unless every lane ends
    DONE."""
    def solve():
        sync(device)
        t0 = time.perf_counter()
        ens = problem.solve(conditions_list=conditions_list)
        sync(device)
        dt = time.perf_counter() - t0
        if not ens.success:
            raise RuntimeError(f"sweep failed: {list(ens.retcodes)[:4]}...")
        return ens, dt

    _, first_s = solve()
    times = []
    for _ in range(repeats):
        ens, dt = solve()
        times.append(dt)
    return ens, first_s, times


def steps_of(ens):
    steps = np.asarray(ens.stats["n_steps"])
    return int(steps.max()), int(np.median(steps))


def mole_err(u, ref) -> float:
    """Max mole-fraction error of a final state against the reference's."""
    return float(np.max(np.abs(u - ref) / max(ref.sum(), 1.0)))


def cpu_baseline_seconds(sd, rd, calc, conditions, pars, best_of: int = 3):
    """scipy-BDF of one profile on the pure-numpy system -> ``(best_s,
    final_y)``; the chunkwise-local-time form where the global-time solve
    underflows its step (``bench.py``'s ``cpu_baseline_seconds``)."""
    from ..solving.solve_utils import make_u0
    from ..testing.cpu_reference import (scipy_bdf_baseline,
                                         scipy_bdf_chunked_baseline)
    u0 = make_u0(sd, pars)
    prof = conditions.get_profile("T")
    try:
        return scipy_bdf_baseline(sd, rd, calc, prof, pars.tspan, u0,
                                  pars.reltol, pars.abstol, best_of=best_of)
    except AssertionError:
        n_chunks = int(round((pars.tspan[1] - pars.tspan[0])
                             / pars.solve_chunkstep))
        log("global-time CPU baseline h-underflowed; using the "
            f"chunkwise-local-time formalism ({n_chunks} chunks)")
        return scipy_bdf_chunked_baseline(sd, rd, calc, prof, pars.tspan, u0,
                                          pars.reltol, pars.abstol,
                                          n_chunks=n_chunks, best_of=best_of)


def platform(device) -> str:
    """The JAX naming of the device's platform: "gpu" for a CUDA card."""
    return "gpu" if device.type == "cuda" else device.type


def append_json(path, record: dict) -> None:
    """Append ``record`` as one JSON line to ``path``; the JAX side's record
    files under ``scripts/`` are refused."""
    path = Path(path).resolve()
    if JAX_RECORDS in path.parents:
        raise ValueError(f"{path} is under the JAX side's scripts/: the "
                         "port's records go elsewhere")
    with open(path, "a") as fh:
        fh.write(json.dumps(record) + "\n")


def run(device="cuda", repeats: int = 3):
    """The benchmark -> ``(record, ens)``; raises if the gate fails."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    device = resolve_device(device)
    s = settings()
    sd, rd, calc, conditions_list, pars = build(device)
    log(f"{sd.n} species, {rd.nr} reactions, batch {s['batch']}, device "
        f"{device_label(device)}")
    cpu_dt, cpu_final = cpu_baseline_seconds(sd, rd, calc, conditions_list[0],
                                             pars)
    log(f"CPU BDF single profile: {cpu_dt:.2f}s")

    problem = ensemble(sd, rd, calc, conditions_list, pars, device)
    ens, first_s, times = timed_sweeps(problem, conditions_list, device,
                                       repeats)
    sweep_s = float(np.median(times))
    batch = s["batch"]
    per_profile = sweep_s / batch
    err = mole_err(ens.u[0, -1], cpu_final)
    steps_max, steps_median = steps_of(ens)
    log(f"device sweep: median {sweep_s:.3f}s of {repeats} "
        f"({per_profile * 1e3:.2f} ms/profile; first call incl. builds "
        f"{first_s:.1f}s); max mole-fraction error vs CPU BDF {err:.2e}; "
        f"steps max={steps_max} median={steps_median}")
    if not err <= GATE:
        raise RuntimeError(f"accuracy gate failed: member 0 is {err:.3e} "
                           f"from scipy-BDF in max mole fraction (> {GATE})")
    speedup = cpu_dt / per_profile
    record = {
        "metric": METRIC, "value": speedup, "unit": "x_vs_cpu_bdf",
        "vs_baseline": speedup,
        "extra": {
            "crn": f"{rd.nr}rxn/{sd.n}sp", "batch": batch,
            "platform": platform(device),
            "per_profile_ms": per_profile * 1e3,
            "cpu_baseline_s": cpu_dt, "max_molefrac_err": err,
            "steps_max": steps_max, "steps_median": steps_median,
            "ms_per_step": sweep_s * 1e3 / steps_max,
            "chunk_mode": problem.chunk_mode,
            "compile_s": first_s - sweep_s, "repeats": repeats,
            "sweep_s": times,
            "per_profile_ms_min": min(times) * 1e3 / batch,
            "per_profile_ms_max": max(times) * 1e3 / batch,
            "device": device_label(device)}}
    return record, ens


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed sweeps after the first call (default 3)")
    args = p.parse_args(argv)
    record, _ = run(args.device, args.repeats)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
