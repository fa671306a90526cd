"""Controller audit: the BDF's step counts against scipy-BDF's, per lane.

    python -m kinetica_tpu_torch.scripts.step_count_audit [rate ...]
        [--device cuda]

The port of the JAX package's ``scripts/step_count_audit.py``. A
batch-synchronous sweep pays for its slowest lane, so the controller's
quality (initial h, order selection, growth limits) is wall time. For each
ramp rate (K/s; default the bench sweep's 40, 50 and 60) it solves the
bench's network (``KINETICA_BENCH_NC``, default 24) through
``solve_network`` chunkwise, 28 chunks of 0.5 s over 14 s at rtol 1e-8 /
atol 1e-10, and counts its accepted steps (``n_accepted``: ``n_steps``
counts rejected attempts too) against scipy-BDF's on the same chunk
sequence in chunkwise local time, at the same tolerances, on the
pure-numpy system of :mod:`kinetica_tpu_torch.testing.cpu_reference`.

The JAX script runs on the CPU, holding step counts to be a property of
the controller. The port runs on the card by default and on the CPU with
``--device cpu``, so the two can be compared: the card's f32 Jacobian and
factors round differently from the CPU's. Prints the JAX script's table
(rate, ours, scipy, ratio, rejected). It writes no file.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..examples import device_label
from . import bench

TF = 14.0
CHUNKSTEP = 0.5
RATES = (40.0, 50.0, 60.0)


def scipy_steps(sd, rd, calc, conds, pars) -> int:
    """scipy-BDF's accepted steps over the chunks in chunkwise local time."""
    from scipy.integrate import solve_ivp

    from ..solving.solve_utils import make_u0
    from ..testing.cpu_reference import (arrhenius_k_of_t,
                                         build_numpy_mass_action)
    rhs_factory, jac_factory = build_numpy_mass_action(sd, rd)[:2]
    k_of_t = arrhenius_k_of_t(calc, conds.get_profile("T"))
    rhs_f, jac_f = rhs_factory(k_of_t), jac_factory(k_of_t)
    y = np.asarray(make_u0(sd, pars))
    n = 0
    for nc in range(int(round(TF / CHUNKSTEP))):
        t_shift = nc * CHUNKSTEP
        sol = solve_ivp(
            lambda t, yv: rhs_f(t + t_shift, yv), (0.0, CHUNKSTEP), y,
            method="BDF", jac=lambda t, yv: jac_f(t + t_shift, yv),
            rtol=bench.RTOL, atol=bench.ATOL)
        if not sol.success:
            raise RuntimeError(f"scipy-BDF failed in chunk {nc}: "
                               f"{sol.message}")
        y = sol.y[:, -1]
        n += sol.t.size - 1
    return n


def main(argv=None) -> list:
    from ..calculators.builtin import PrecalculatedArrheniusCalculator
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import LinearGradientProfile
    from ..solving.methods import VariableODESolve, solve_network
    from ..solving.params import ODESimulationParams
    from ..testing.synthetic import synthetic_pyrolysis_network

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rates", nargs="*", type=float, default=list(RATES),
                   help="ramp rates in K/s (default 40 50 60)")
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    nc = int(os.environ.get("KINETICA_BENCH_NC", str(bench.N_CARBONS)))
    sd, rd, Ea, A = synthetic_pyrolysis_network(nc)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=bench.K_MAX,
                                            device=device)
    n_chunks = int(round(TF / CHUNKSTEP))
    bench.log(f"device {device_label(device)}")
    print(f"{rd.nr} rxns / {sd.n} species, tf={TF}, {n_chunks} chunks, "
          f"rtol={bench.RTOL} atol={bench.ATOL}")
    print(f"{'rate':>6} {'ours':>6} {'scipy':>6} {'ratio':>6}  "
          f"(accepted steps both sides, chunk-summed)", flush=True)
    rows = []
    for r in args.rates:
        conds = ConditionSet({"T": LinearGradientProfile(
            rate=r, X_start=500.0, X_end=500.0 + r * TF)})
        pars = ODESimulationParams(
            tspan=(0.0, TF), u0={f"C{nc}": 1.0}, solve_chunks=True,
            solve_chunkstep=CHUNKSTEP, low_k_cutoff="none",
            abstol=bench.ATOL, reltol=bench.RTOL)
        res = solve_network(VariableODESolve(pars, conds, calc), sd, rd,
                            device=device)
        if not res.sol.success:
            raise RuntimeError(f"rate {r}: {res.sol.retcode}")
        ours = int(np.sum(np.asarray(res.sol.stats["n_accepted"])))
        rej = int(np.sum(np.asarray(res.sol.stats["n_rejected"])))
        sp = scipy_steps(sd, rd, calc, conds, pars)
        rows.append({"rate": r, "ours": ours, "scipy": sp,
                     "ratio": ours / sp, "rejected": rej})
        print(f"{r:>6.1f} {ours:>6d} {sp:>6d} {ours / sp:>6.2f}  "
              f"(+{rej} rejected)", flush=True)
    return rows


if __name__ == "__main__":
    main()
