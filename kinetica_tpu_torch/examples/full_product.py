"""The full product loop in one command, on the card: explore -> solve ->
analyse.

The port of ``examples/full_product.py`` (the reference's README promise:
automated exploration of chemical reaction networks plus kinetic
modelling under arbitrary conditions, and the analysis layer on top):

  1. EXPLORE: kinetics-gated iterative CRN exploration; the native
     cde_lite sampler grows the mechanism level by level, each level
     gated by one batched device solve of the network so far over a
     ramp-rate sweep (methods.jl:150-266; solve gate at :221).
  2. SOLVE: batched condition sweep of the final network.
  3. SCREEN: Morris elementary effects: which rate constants does the
     observable respond to (one batched sweep)?
  4. REDUCE: DRGEP skeletal reduction with re-solve validation: the
     smallest sub-mechanism reproducing the target profile within
     tolerance.

    python -m kinetica_tpu_torch.examples.full_product [--device cuda]
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from kinetica_tpu_torch import morris_screening
from kinetica_tpu_torch.analysis.reduction import reduce_network_drgep
from kinetica_tpu_torch.conditions.condition_set import ConditionSet
from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
from kinetica_tpu_torch.core.network import format_rxn
from kinetica_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from kinetica_tpu_torch.examples import device_label, parser
from kinetica_tpu_torch.exploration import CDE, IterativeExplore, explore_network
from kinetica_tpu_torch.exploration.cde_lite import (build_cde_lite,
                                                     get_cde_lite_exec,
                                                     write_minimal_template)
from kinetica_tpu_torch.parallel.batching import EnsembleProblem
from kinetica_tpu_torch.solving.methods import StaticODESolve, VariableODESolve
from kinetica_tpu_torch.solving.params import ODESimulationParams
from kinetica_tpu_torch.testing.explore_config import UniformArrhenius


def main(n_sweep: int = 16, max_levels: int = 3, quiet: bool = False,
         reduce_tol: float = 1e-3, workdir: str | None = None,
         device=DEFAULT_DEVICE, record: dict | None = None):
    """Explore, sweep, screen and reduce under ``workdir`` (a new temporary
    directory by default); returns ``(sd, rd, mres, red)`` as the JAX
    example does. ``record``, where given, receives each stage's results
    as it ends: the explore and solve methods (``em``, ``sm``), the
    explored ``res``, the sweep's ``ens`` and ``target``, ``mres``, ``red``
    and ``stage_s`` (the stages' wall times), so a caller sees the first
    stages when a later one raises (DRGEP raises ``ValueError`` where no
    candidate on its eps ladder meets ``reduce_tol``)."""
    record = {} if record is None else record
    device = resolve_device(device)
    if build_cde_lite() is None:
        raise SystemExit("g++ unavailable: cannot build the native sampler")
    say = (lambda *a: None) if quiet else print
    where = device_label(device)
    workdir = workdir or tempfile.mkdtemp(prefix="kinetica_full_product_")
    template = write_minimal_template(os.path.join(workdir, "template"),
                                      nrxn_per_mech=2)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    # ---- 1. EXPLORE: kinetics-gated iterative mechanism growth ----
    tf = 10.0
    rates = np.linspace(40.0, 80.0, n_sweep)
    conditions_list = [
        ConditionSet({"T": LinearGradientProfile(
            rate=float(r), X_start=600.0, X_end=600.0 + float(r) * tf)})
        for r in rates]
    pars = ODESimulationParams(tspan=(0.0, tf), u0={"CC": 1.0},
                               solve_chunks=True, solve_chunkstep=tf / 10,
                               low_k_cutoff="none")
    calc = UniformArrhenius(device=device)
    solvemethod = VariableODESolve(pars, conditions_list[0], calc)
    timings: list = []
    exploremethod = IterativeExplore(
        rdir_head=os.path.join(workdir, "crn"),
        reac_smiles=["CC"],
        rxn_convergence_threshold=2,
        seed_convergence_threshold=2,
        seed_conc=0.05,
        max_levels=max_levels,
        solve_conditions_list=conditions_list,
        timings=timings, gate_log=[],
        cde=CDE(template_dir=template, cde_exec=get_cde_lite_exec(),
                sampling_seed=7, nrxn=4, radius=1))
    stage_s = []
    record.update(stage_s=stage_s, workdir=workdir,
                  conditions_list=conditions_list, em=exploremethod,
                  sm=solvemethod)
    t0 = clock()
    res = explore_network(exploremethod, solvemethod,
                          savedir=os.path.join(workdir, "out"), device=device)
    sd, rd = res.sd, res.rd
    stage_s.append(clock() - t0)
    record.update(res=res)
    say(f"[1/4] explored {len(timings)} levels -> {sd.n} species / "
        f"{rd.nr} reactions in {stage_s[-1]:.1f}s "
        f"(per-level device solve "
        f"{[t['solve_s'] for t in timings]} s) [{where}]")

    # observable: the most abundant non-feed product under the sweep
    u_final = np.asarray(res.sol.u)[-1]
    order = np.argsort(u_final)[::-1]
    target = next(sd.toStr[i] for i in order
                  if sd.toStr[i] != "CC" and u_final[i] > 1e-10)

    # ---- 2. SOLVE: batched sweep of the final network ----
    t0 = clock()
    prob = EnsembleProblem(solvemethod, sd, rd, device=device)
    ens = prob.solve(conditions_list=conditions_list)
    assert ens.success
    stage_s.append(clock() - t0)
    record.update(ens=ens, target=target)
    say(f"[2/4] {n_sweep}-profile sweep of the final CRN in "
        f"{stage_s[-1]:.1f}s ({stage_s[-1] / n_sweep * 1e3:.0f} ms/profile); "
        f"observable {target!r} [{where}]")

    # ---- 3. SCREEN: Morris elementary effects on the observable ----
    t0 = clock()
    static = StaticODESolve(
        ODESimulationParams(tspan=(0.0, tf), u0={"CC": 1.0},
                            solve_chunks=True, solve_chunkstep=tf / 10,
                            low_k_cutoff="none"),
        ConditionSet({"T": 900.0}), calc)
    mres = morris_screening(static, sd, rd, objective=target,
                            n_trajectories=4, device=device)
    rank = np.argsort(mres.mu_star)[::-1]
    stage_s.append(clock() - t0)
    record.update(mres=mres)
    say(f"[3/4] Morris screening ({stage_s[-1]:.1f}s) [{where}]: "
        "top channels:")
    for rid in rank[:3]:
        say(f"      mu*={mres.mu_star[rid]:.3g}  "
            f"{format_rxn(sd, rd, int(rid))}")

    # ---- 4. REDUCE: DRGEP + re-solve validation ----
    t0 = clock()
    red = reduce_network_drgep(static, sd, rd, targets=[target],
                               tol=reduce_tol, device=device)
    keep = red.reduction
    stage_s.append(clock() - t0)
    record.update(red=red)
    say(f"[4/4] DRGEP ({stage_s[-1]:.1f}s) [{where}]: "
        f"{rd.nr} -> {len(keep.keep_rids)} reactions / {sd.n} -> "
        f"{int(np.sum(keep.keep_species))} species at "
        f"eps={keep.eps:.3g}, validated max deviation "
        f"{red.error:.2e} <= {reduce_tol:g}")
    say(f"\nRun tree (restartable): {os.path.join(workdir, 'crn')}")
    return sd, rd, mres, red


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
