"""Measurements behind the forward-sensitivity findings.

Three checks, each printing one JSON line:

* ``trace``: the ramp of ``chip_smoke.py`` phase 14b
  (``synthetic_pyrolysis_network(24)``, 700 -> 1100 K at 100 K/s, rates
  every 0.5 s) over its first chunk, as one batch of three lanes: a dual
  lane carrying the tangent of ``theta[rid]`` and the lanes theta[rid] =
  +-eps. After every step it compares the dual lane's tangent of u with
  the difference quotient of the other two, and prints for the first
  steps the species where they part most (its tangent and quotient) and
  the largest |quotient| of the step;
* ``scipy-tol``: scipy-BDF on phase 11's static problem (650 K, tf 0.05
  s) at rtol / atol 1e-8 / 1e-10 and 1e-10 / 1e-16, their max
  mole-fraction difference and times;
* ``overhead``: wall ms per step of the sensitivity solve (dual lanes)
  against the same solve with plain lanes (``_solve_theta``), on the nc=6
  ramp of ``tests/test_sensitivity.py``, and the time of ``x / 1e-12`` on
  a dual and on a plain (4, 19) tensor.

Usage: ``python -m kinetica_tpu_torch.scripts.sensitivity_checks
{trace,scipy-tol,overhead} [--device cpu] [--rid 0] [--eps 1e-4]``; the
default device is the card.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch
from torch.autograd import forward_ad

from ..calculators.builtin import PrecalculatedArrheniusCalculator
from ..conditions.condition_set import ConditionSet
from ..conditions.profiles import LinearGradientProfile
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.mass_action import resolve_clip_delta
from ..ops import bdf
from ..solving.methods import StaticODESolve, VariableODESolve
from ..solving.params import ODESimulationParams
from ..solving.sensitivity import SensitivityProblem
from ..solving.solve_utils import make_u0
from ..testing.cpu_reference import scipy_bdf_static
from ..testing.synthetic import synthetic_pyrolysis_network


def ramp_problem(nc, device, rids):
    sd, rd, Ea, A = synthetic_pyrolysis_network(nc)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=device)
    cs = ConditionSet({"T": LinearGradientProfile(
        rate=100.0, X_start=700.0, X_end=1100.0)}, ts_update=0.5)
    tf = cs.get_t_final()
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{nc}": 1.0}, solve_chunks=True,
        solve_chunkstep=tf / 8, low_k_cutoff="none", abstol=1e-10,
        reltol=1e-8)
    return SensitivityProblem(VariableODESolve(pars, cs, calc), sd, rd,
                              rids=rids, device=device), sd


def trace(device, rid, eps, shown=32):
    prob, sd = ramp_problem(24, device, [rid])
    prob.n_chunks = 1
    steps = []
    merge = bdf._State.merge

    def record(state, mask, **new):
        merge(state, mask, **new)
        if "D" in new:
            u, du = forward_ad.unpack_dual(state.D[:, 0])
            steps.append((float(forward_ad.unpack_dual(state.t)[0][0]),
                          u.detach().clone(), du[0].detach().clone()))

    bdf._State.merge = record
    try:
        with forward_ad.dual_level():
            theta = torch.tensor([[0.0], [eps], [-eps]], dtype=torch.float64,
                                 device=device)
            prob._solve_theta(forward_ad.make_dual(
                theta, torch.tensor([[1.0], [0.0], [0.0]],
                                    dtype=torch.float64, device=device)))
    finally:
        bdf._State.merge = merge
    rows = []
    for i, (t, u, du) in enumerate(steps[:shown]):
        fd = (u[1] - u[2]) / (2 * eps)
        j = int((du - fd).abs().argmax())
        rows.append({"step": i, "t": t, "species": sd.toStr[j],
                     "tangent": float(du[j]), "quotient": float(fd[j]),
                     "u": float(u[0, j]),
                     "max_abs_quotient": float(fd.abs().max())})
    return {"rid": rid, "eps": eps, "steps": len(steps), "first": rows}


def scipy_tol():
    sd, rd, Ea, A = synthetic_pyrolysis_network(24)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")
    pars = ODESimulationParams(tspan=(0.0, 0.05), u0={"C24": 1.0},
                               low_k_cutoff="none", abstol=1e-10, reltol=1e-8)
    method = StaticODESolve(pars, ConditionSet({"T": 650.0}), calc)
    k = method.calculator(650.0).numpy()
    out = {}
    for rtol, atol in ((1e-8, 1e-10), (1e-10, 1e-16)):
        t0 = time.perf_counter()
        out[(rtol, atol)] = (scipy_bdf_static(
            sd, rd, k, 0.05, make_u0(sd, pars), rtol, atol,
            resolve_clip_delta(pars)), time.perf_counter() - t0)
    (u1, s1), (u2, s2) = out.values()
    return {"max_mole_fraction_diff": float(np.max(np.abs(u1 - u2))
                                            / max(u2.sum(), 1.0)),
            "seconds_1e-8": s1, "seconds_1e-10": s2}


def overhead(device):
    prob, _ = ramp_problem(6, device, [0, 3, 7])
    t0 = time.perf_counter()
    sens = prob.solve()
    dual_ms = (time.perf_counter() - t0) * 1e3 / sens.stats["n_steps"]
    t0 = time.perf_counter()
    prob._solve_theta(np.zeros((3, 3)))
    plain_ms = (time.perf_counter() - t0) * 1e3 / prob.last_stats["n_steps"]
    x = torch.rand(4, 19, dtype=torch.float64, device=device)

    def per_call_us(fn, n=200):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    with forward_ad.dual_level():
        xd = forward_ad.make_dual(x, torch.ones_like(x))
        div_dual = per_call_us(lambda: xd / 1e-12)
    return {"lanes": 3, "dual_ms_per_step": dual_ms,
            "plain_ms_per_step": plain_ms, "div_scalar_us_dual": div_dual,
            "div_scalar_us_plain": per_call_us(lambda: x / 1e-12)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("check", choices=("trace", "scipy-tol", "overhead"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--rid", type=int, default=0)
    ap.add_argument("--eps", type=float, default=1e-4)
    args = ap.parse_args()
    logging.getLogger("kinetica_tpu_torch").setLevel(logging.WARNING)
    device = resolve_device(args.device)
    if args.check == "trace":
        res = trace(device, args.rid, args.eps)
    elif args.check == "scipy-tol":
        res = scipy_tol()
    else:
        res = overhead(device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
