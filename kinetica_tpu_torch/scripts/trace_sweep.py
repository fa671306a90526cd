"""Where the device time of the nc=60 continuous sweep goes.

    python -m kinetica_tpu_torch.scripts.trace_sweep [--tf 1.0] [--batch 64]
        [--out FILE]

The sweep of ``chip_smoke.py`` phase 8 (``synthetic_pyrolysis_network(60)``:
4473 reactions, 181 species; 40-60 K/s ramps from 500 K; chunks of 0.5 s;
continuous rates, ``inv_gated`` through the block-Schur inverse, the fused
RHS) over its first ``tf`` seconds: a B=8 warm-up, one untimed warm run,
one run on the host clock, then one run under ``torch.profiler``. Prints
(and writes as JSON to ``--out FILE``, if given):

* wall time, steps max, ms/step, host syncs per step (untraced run);
* device busy time (the sum of the device kernels' and copies' times in
  the traced run), the device's idle share of the untraced wall time,
  ``cudaLaunchKernel`` calls per step, the top device kernels;
* the share of device time of the Gauss-Jordan and fused-RHS kernels;
* a breakdown of ``schur_inverse`` at n = 181, B = 64 by kernel (20 calls
  traced): the Gauss-Jordan launches against the f32 products and the
  elementwise kernels of the composition.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..calculators.builtin import PrecalculatedArrheniusCalculator
from ..conditions.condition_set import ConditionSet
from ..conditions.profiles import LinearGradientProfile
from ..ops import gj_inverse, host_sync
from ..ops.linalg import _equilibrate
from ..parallel.batching import EnsembleProblem
from ..solving.methods import VariableODESolve
from ..solving.params import ODESimulationParams
from ..testing.synthetic import synthetic_pyrolysis_network

NC, CHUNK, RTOL, ATOL, K_MAX = 60, 0.5, 1e-8, 1e-10, 1e12


def _problem(dev, batch, tf):
    sd, rd, Ea, A = synthetic_pyrolysis_network(NC)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=dev)
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=500.0, X_end=500.0 + float(r) * tf)})
        for r in np.linspace(40.0, 60.0, batch)]
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
        jac_policy="lazy", lu_drift_tol=0.3, linsolve="auto",
        rhs_contraction="auto")
    problem = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                              rate_mode="continuous", device=dev)
    return problem, conds


def _device_events(prof):
    """(name, device us, count) of every device-side entry."""
    out = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out.append((e.key, float(us), int(e.count)))
    return sorted(out, key=lambda t: -t[1])


def _launch_calls(prof):
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx"))


def _share(events, part):
    total = sum(us for _, us, _ in events)
    return sum(us for k, us, _ in events if part in k) / max(total, 1e-300)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tf", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("trace_sweep: no CUDA card")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__}", flush=True)

    warm, wconds = _problem(dev, 8, 2 * CHUNK)
    warm.solve(conditions_list=wconds)
    problem, conds = _problem(dev, args.batch, args.tf)
    problem.solve(conditions_list=conds)
    torch.cuda.synchronize()
    host_sync.count = 0
    t0 = time.perf_counter()
    ens = problem.solve(conditions_list=conds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = host_sync.count
    steps = int(np.asarray(ens.stats["n_steps"]).max())
    if not ens.success:
        sys.exit(f"trace_sweep: not every lane DONE: {ens.retcodes}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ens_t = problem.solve(conditions_list=conds)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(us for _, us, _ in events) * 1e-6
    steps_t = int(np.asarray(ens_t.stats["n_steps"]).max())
    launches = _launch_calls(prof)

    # the block-Schur inverse alone, n = 181, B = 64
    rng = np.random.default_rng(7)
    A = torch.as_tensor(np.eye(181) + rng.standard_normal((args.batch, 181, 181))
                        / (2.0 * np.sqrt(181)), dtype=torch.float32, device=dev)
    A = _equilibrate(A)[0].contiguous()
    for _ in range(3):
        gj_inverse.schur_inverse(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as sprof:
        for _ in range(20):
            gj_inverse.schur_inverse(A)
        torch.cuda.synchronize()
    schur = _device_events(sprof)

    result = dict(
        card=card, batch=args.batch, tf=args.tf, wall_s=wall, steps_max=steps,
        ms_per_step=wall * 1e3 / steps, host_syncs_per_step=syncs / steps,
        traced_s=traced, traced_steps_max=steps_t, device_busy_s=busy,
        device_idle_share=1.0 - busy / wall,
        launches_per_step=launches / steps_t,
        gj_share=_share(events, "gj_inverse_kernel"),
        fused_rhs_share=_share(events, "fused_rhs_kernel"),
        top=[dict(name=k[:90], ms=us * 1e-3, count=n) for k, us, n in events[:15]],
        schur_n181=[dict(name=k[:90], ms_per_call=us * 1e-3 / 20,
                         launches_per_call=n / 20) for k, us, n in schur])
    for key in ("wall_s", "steps_max", "ms_per_step", "host_syncs_per_step",
                "traced_s", "device_busy_s", "device_idle_share",
                "launches_per_step", "gj_share", "fused_rhs_share"):
        print(f"{key}: {result[key]}", flush=True)
    for row in result["top"]:
        print(f"  {row['ms']:10.3f} ms {row['count']:7d}x  {row['name']}")
    print("schur_inverse n=181 B=64, per call:")
    for row in result["schur_n181"]:
        print(f"  {row['ms_per_call']:9.5f} ms {row['launches_per_call']:5.1f}x  "
              f"{row['name']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))


if __name__ == "__main__":
    main()
