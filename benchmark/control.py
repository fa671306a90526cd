"""The readings that a cell's limits are set from: the program's sound runs
and its control, at the cell's own size. Not run by the benchmark's runs.

    python3 -m benchmark.control --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--out FILE]

For each seed it solves the window's first batch of that seed through the
cell's entry (set up once), and compares it as a run does
(``check.compare`` and ``check.passed`` with the cell's own limits). For
each control seed (one of ``--seeds``) it puts the control in the
program's place in the lanes that comparison samples: the plain reference
at the configuration's own tolerances with its state held in float32
wherever it is handed on (``reference.solve_ramp``), the step below the
configuration's float64. The rest of the batch keeps the program's
answers, so only the control is judged. One JSON line a reading on
standard output (and in ``--out``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, network
from . import traffic as traffic_mod
from .harness import Spec


def _judged(config, traffic, answers, seed, limits) -> dict:
    checks = check.compare(config, traffic, answers, seed, limits)
    return {"max_molefrac_err": checks["max_molefrac_err"]["value"],
            "limit": checks["max_molefrac_err"]["limit"],
            "failed_lanes": checks["failed_lanes"]["value"],
            "correct": check.passed(checks)}


def readings(spec: Spec, workload: str, seeds, control_seeds, device,
             emit=print) -> list[dict]:
    """One reading a (side, seed): ``{"side", "seed", "max_molefrac_err",
    "limit", "failed_lanes", "correct"}``, the program's also
    ``steps_max`` and ``solve_s``."""
    if not set(control_seeds) <= set(seeds):
        raise ValueError("every control seed must be one of the seeds")
    cell = spec.workload(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = check.load_limits(spec.root, workload)
    net = network.from_config(config)
    entry = spec.module("entries", traffic["entry"]).make(config, net,
                                                          traffic, device)
    entry.warm_up(traffic_mod.Ramps(traffic, seeds[0],
                                    traffic_mod.WARMUP).next_batch())
    out = []
    for seed in seeds:
        rates = traffic_mod.Ramps(traffic, seed).next_batch()
        t0 = time.perf_counter()
        res = entry.solve(rates)
        solve_s = time.perf_counter() - t0
        answers = [(rates, res.u, res.ok, res.n_steps)]
        rows = [{"side": "program", "seed": seed,
                 **_judged(config, traffic, answers, seed, limits),
                 "steps_max": res.steps_max, "solve_s": solve_s}]
        if seed in control_seeds:
            lanes = [b for _, b in check.pick(answers,
                                              int(traffic["check_lanes"]),
                                              seed)]
            u = res.u.copy()
            u[lanes] = check.reference_states(config, traffic, rates[lanes],
                                              control=True)
            rows.append({"side": "control", "seed": seed, **_judged(
                config, traffic, [(rates, u, res.ok, res.n_steps)], seed,
                limits)})
        for row in rows:
            out.append(row)
            emit(json.dumps(row))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = readings(Spec(), args.workload, seeds, cseeds,
                    torch.device("cuda:0"),
                    emit=lambda line: print(line, flush=True))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in rows))
    for side in ("program", "control"):
        vals = [r["max_molefrac_err"] for r in rows if r["side"] == side]
        if vals:
            print(f"{side}: max {max(vals)!r} min {min(vals)!r} over "
                  f"{len(vals)} seeds, correct "
                  f"{[r['correct'] for r in rows if r['side'] == side]}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
