"""The adjoint gradient against central differences, by storage grid.

``solve_adjoint_gradient`` reads u(t) in its backward Jacobian from a
cubic Hermite interpolant over ``n_store`` graded nodes. This script runs
the gradient of u_C1(0.05 s) at 650 K on ``synthetic_pyrolysis_network(24)``
(phase 11 of ``chip_smoke.py``) for several ``n_store`` at the quadrature
grid of 257 nodes, and prints the top three reactions' gradients beside
central differences of scipy-BDF (rtol 1e-10, 1e-3 in ln k) with the
backward solve's steps and factors.

Usage: ``python -m kinetica_tpu_torch.scripts.adjoint_storage [--device
cpu] [--threads N] [--n-store 257 2049 8193]``; the default device is the
card.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from ..calculators.builtin import PrecalculatedArrheniusCalculator
from ..conditions.condition_set import ConditionSet
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import resolve_clip_delta
from ..solving import adjoint
from ..solving.methods import StaticODESolve
from ..solving.params import ODESimulationParams
from ..solving.solve_utils import make_u0
from ..testing.cpu_reference import scipy_bdf_static
from ..testing.synthetic import synthetic_pyrolysis_network

T, TF, NC = 650.0, 0.05, 24


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    ap.add_argument("--n-store", type=int, nargs="+",
                    default=[257, 2049, 8193])
    args = ap.parse_args()
    logging.disable(logging.INFO)
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    sd, rd, Ea, A = synthetic_pyrolysis_network(NC)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=dev)
    pars = ODESimulationParams(tspan=(0.0, TF), u0={f"C{NC}": 1.0},
                               low_k_cutoff="none")
    method = StaticODESolve(pars, ConditionSet({"T": T}), calc)
    w = np.zeros(sd.n)
    w[sd.toInt["C1"]] = 1.0

    k = calc(T).cpu().numpy()
    u0 = make_u0(sd, pars)
    fd = {}
    for j in (872, 0, 145):
        gs = [float(w @ scipy_bdf_static(sd, rd, k * np.where(
            np.arange(rd.nr) == j, np.exp(sign * 1e-3), 1.0), TF, u0, 1e-10,
            1e-20, resolve_clip_delta(pars))) for sign in (1.0, -1.0)]
        fd[j] = (gs[0] - gs[1]) / 2e-3
    print(json.dumps({"central_differences": fd}), flush=True)
    for n_store in args.n_store:
        t0 = time.perf_counter()
        grad, g = adjoint.solve_adjoint_gradient(method, sd, rd, w,
                                                 n_nodes=257, device=dev,
                                                 n_store=n_store)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(json.dumps({
            "device": str(dev), "n_store": n_store, "g": g,
            "grad": {j: float(grad[j]) for j in fd},
            "rel_err": {j: float(abs(grad[j] - v) / abs(v))
                        for j, v in fd.items()},
            "backward": adjoint.last_stats["backward"],
            "forward": adjoint.last_stats["forward"],
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
