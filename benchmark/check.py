"""Whether the timed path's answers are right: the comparison that decides
``correct``.

After the window has closed and the program's state is freed, a sample of
the lanes the run solved, drawn from the seed (the lane with the most
steps of the first solve always in it), is solved again by the plain
reference (``reference.py``, SciPy BDF in float64 at the configuration's
tighter reference tolerances) from the same network arrays and ramps, in a
few worker processes. Numbers compared, each against the limit in
``limits/<workload>.json``:

* ``max_molefrac_err``: over the sampled lanes, every save (the start and
  each chunk's end) and every species, the largest |u - u_ref| divided by
  the reference's total moles at that save (at least 1);
* ``failed_lanes``: lanes of the run that did not end with the program's
  success retcode, or whose states are not finite (limit 0).
"""
from __future__ import annotations

import json
import multiprocessing
import os
from pathlib import Path

import numpy as np

from . import network, reference
from .traffic import SAMPLE, seed_words

BLAS_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def load_limits(root: Path, workload: str) -> dict:
    path = Path(root) / "benchmark" / "limits" / f"{workload}.json"
    if not path.exists():
        raise FileNotFoundError(f"{workload}: no limits file {path}")
    return json.loads(path.read_text())


def pick(answers, n: int, seed: int) -> list[tuple[int, int]]:
    """``n`` (solve, lane) pairs of ``answers`` (a list of (rates, u, ok,
    n_steps) per solve): the first solve's lane of most steps, then others
    drawn from the seed without repeats."""
    pool = [(s, b) for s, a in enumerate(answers) for b in range(len(a[0]))]
    first = (0, int(np.argmax(answers[0][3])))
    rest = [p for p in pool if p != first]
    rng = np.random.default_rng(seed_words(seed, SAMPLE))
    order = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [first] + [rest[i] for i in sorted(order)]


def _reference_job(job):
    config, rate, T0, tf, chunk, control = job
    net = network.from_config(config)
    u0 = np.zeros(net.ns)
    for name, x in config["initial"].items():
        u0[net.species.index(name)] = x
    n_chunks = int(round(tf / chunk))
    saves = np.arange(n_chunks + 1) * chunk
    if control:
        rtol, atol = config["solver"]["reltol"], config["solver"]["abstol"]
    else:
        rtol, atol = config["reference"]["rtol"], config["reference"]["atol"]
    return reference.solve_ramp(net, u0, rate, T0, tf, saves,
                                config["rates"]["k_max"], rtol, atol,
                                state_dtype=np.float32 if control
                                else np.float64)


def reference_states(config: dict, traffic: dict, rates: list[float],
                     control: bool = False) -> list[np.ndarray]:
    """The reference's states for each rate, in worker processes (spawned,
    one BLAS thread each), all joined before this returns. ``control``:
    the control's states instead, the reference at the configuration's
    own tolerances with its state held in float32."""
    jobs = [(config, float(r), traffic["ramp"]["T0"], traffic["tf"],
             traffic["chunk"], control) for r in rates]
    workers = max(1, min(len(jobs), 6, (os.cpu_count() or 2) - 1))
    if workers == 1:
        return [_reference_job(j) for j in jobs]
    saved = {k: os.environ.get(k) for k in BLAS_ENV}
    os.environ.update({k: "1" for k in BLAS_ENV})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            out = pool.map(_reference_job, jobs)
            pool.close()
            pool.join()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def molefrac_err(u: np.ndarray, ref: np.ndarray) -> float:
    """max over saves and species of |u - ref| / max(sum(ref), 1)."""
    total = np.maximum(ref.sum(axis=-1, keepdims=True), 1.0)
    return float(np.max(np.abs(u - ref) / total))


def compare(config: dict, traffic: dict, answers, seed: int,
            limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` of every number compared."""
    failed = sum(int(np.sum(~ok | ~np.isfinite(u).all(axis=(1, 2))))
                 for _, u, ok, _ in answers)
    lanes = pick(answers, int(traffic["check_lanes"]), seed)
    refs = reference_states(config, traffic,
                            [answers[s][0][b] for s, b in lanes])
    # np.max, unlike max(), carries a NaN through
    err = float(np.max([molefrac_err(answers[s][1][b], ref)
                        for (s, b), ref in zip(lanes, refs)]))
    if not np.isfinite(err):
        err = float("inf")
    return {"max_molefrac_err": {"value": err,
                                 "limit": limits["max_molefrac_err"]["limit"]},
            "failed_lanes": {"value": failed,
                             "limit": limits["failed_lanes"]["limit"]}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
