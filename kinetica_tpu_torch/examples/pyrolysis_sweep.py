"""Batched condition sweep of a ~10^3-reaction pyrolysis CRN on the card.

The port of ``examples/pyrolysis_sweep.py`` (BASELINE.md configs 3+4):
long-timescale stiff solves of a synthetic radical-chain cracking network
under a family of temperature ramps, run as one batched chunkwise BDF
sweep (``EnsembleProblem``, discrete rate updates every 0.25 s). The
first solve builds the kernels; the second is timed.

    python -m kinetica_tpu_torch.examples.pyrolysis_sweep [batch] [--device cuda]
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from kinetica_tpu_torch.calculators.builtin import (
    PrecalculatedArrheniusCalculator)
from kinetica_tpu_torch.conditions.condition_set import ConditionSet
from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
from kinetica_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from kinetica_tpu_torch.examples import device_label, parser
from kinetica_tpu_torch.parallel.batching import EnsembleProblem
from kinetica_tpu_torch.solving.methods import VariableODESolve
from kinetica_tpu_torch.solving.params import ODESimulationParams
from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

TF = 14.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def problem(batch: int = 32, n_carbons: int = 16, device=DEFAULT_DEVICE):
    """``(sd, rd, calc, pars, conditions_list)`` of the sweep: ``batch``
    ramps from 500 K at 40-60 K/s over ``synthetic_pyrolysis_network(
    n_carbons)``, rates updated every 0.25 s."""
    sd, rd, Ea, A = synthetic_pyrolysis_network(n_carbons)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=device)
    conditions_list = [
        ConditionSet({"T": LinearGradientProfile(
            rate=float(r), X_start=500.0, X_end=500.0 + float(r) * TF)},
            ts_update=0.25)
        for r in np.linspace(40.0, 60.0, batch)]
    pars = ODESimulationParams(tspan=(0.0, TF), u0={f"C{n_carbons}": 1.0},
                               solve_chunks=True, solve_chunkstep=0.5,
                               low_k_cutoff="none")
    return sd, rd, calc, pars, conditions_list


def main(batch: int = 32, n_carbons: int = 16, device=DEFAULT_DEVICE):
    """Sweep ``batch`` ramps of ``synthetic_pyrolysis_network(n_carbons)``;
    returns the network, the problem, both solves' ensembles (``first``,
    ``ens``) and wall times."""
    device = resolve_device(device)
    feed = f"C{n_carbons}"
    sd, rd, calc, pars, conditions_list = problem(batch, n_carbons, device)
    print(f"CRN: {sd.n} species, {rd.nr} reactions; sweep of {batch} ramps")
    rates = np.linspace(40.0, 60.0, batch)

    prob = EnsembleProblem(VariableODESolve(pars, conditions_list[0], calc),
                           sd, rd, device=device)
    where = device_label(device)
    _sync(device)
    t0 = time.perf_counter()
    first = prob.solve(conditions_list=conditions_list)
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"first solve (incl. kernel build): {first_s:.1f}s; "
          f"success: {first.success} [{where}]")
    t0 = time.perf_counter()
    ens = prob.solve(conditions_list=conditions_list)
    _sync(device)
    sweep_s = time.perf_counter() - t0
    steps = np.asarray(ens.stats["n_steps"])
    print(f"steady-state sweep: {sweep_s:.2f}s total, "
          f"{sweep_s / batch * 1e3:.1f} ms per profile; steps max/median "
          f"{int(steps.max())}/{int(np.median(steps))} [{where}]")

    cfeed = ens.u[:, -1, sd.toInt[feed]]
    print(f"final {feed} vs heating rate:")
    for r, c in zip(rates[:: max(1, batch // 8)],
                    cfeed[:: max(1, batch // 8)]):
        print(f"  rate {r:5.1f} K/s -> {c:.4e} mol dm^-3")
    return SimpleNamespace(sd=sd, rd=rd, calc=calc, pars=pars,
                           conditions_list=conditions_list, problem=prob,
                           first=first, ens=ens, first_s=first_s,
                           sweep_s=sweep_s, device_label=where)


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("batch", type=int, nargs="?", default=32,
                   help="the number of ramps (default 32)")
    a = p.parse_args()
    main(a.batch, device=a.device)
