"""Kinetics-gated iterative CRN exploration with the native sampler, on
the card.

The port of ``examples/iterative_exploration.py`` (BASELINE config 5 end
to end): level-by-level mechanism growth where each level's seed species
are chosen from a batched kinetic solve on the device of the network
explored so far, the reference's flagship workflow, driven by the
first-party C++ reaction sampler (``cde_lite``, the external CDE binary's
file contract) and gated by three ramps (40, 60 and 80 K/s).

    python -m kinetica_tpu_torch.examples.iterative_exploration [--device cuda]

Everything is restartable from the run directory tree (rcount counters,
isconv markers, per-level checkpoints) exactly as in the reference.
"""
from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import numpy as np

from kinetica_tpu_torch.conditions.condition_set import ConditionSet
from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
from kinetica_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from kinetica_tpu_torch.examples import parser
from kinetica_tpu_torch.exploration import CDE, IterativeExplore, explore_network
from kinetica_tpu_torch.exploration.cde_lite import (build_cde_lite,
                                                     get_cde_lite_exec,
                                                     write_minimal_template)
from kinetica_tpu_torch.solving.methods import VariableODESolve
from kinetica_tpu_torch.solving.params import ODESimulationParams
from kinetica_tpu_torch.testing.explore_config import UniformArrhenius

RATES = (40.0, 60.0, 80.0)


def main(workdir: str | None = None, device=DEFAULT_DEVICE):
    """Explore from CC under ``workdir`` (a new temporary directory by
    default); returns ``res``, the explore method (``em.timings`` and
    ``em.gate_log`` per level), the solve method and the gate's
    conditions."""
    device = resolve_device(device)
    if build_cde_lite() is None:
        raise SystemExit("g++ unavailable: cannot build the native sampler")
    workdir = workdir or tempfile.mkdtemp(prefix="kinetica_iterative_")
    template = write_minimal_template(os.path.join(workdir, "template"),
                                      nrxn_per_mech=2)

    # a SWEEP of ramp rates gates every level (BASELINE config 5): the
    # per-level kinetic simulation is one batched device solve and
    # next-level seeds are species that matter under ANY swept condition
    tf = 10.0
    conditions_list = [
        ConditionSet({"T": LinearGradientProfile(
            rate=r, X_start=600.0, X_end=600.0 + r * tf)})
        for r in RATES]
    pars = ODESimulationParams(tspan=(0.0, tf), u0={"CC": 1.0},
                               solve_chunks=True, solve_chunkstep=tf / 10,
                               low_k_cutoff="none")
    solvemethod = VariableODESolve(pars, conditions_list[0],
                                   UniformArrhenius(device=device))

    exploremethod = IterativeExplore(
        rdir_head=os.path.join(workdir, "crn"),
        reac_smiles=["CC"],
        rxn_convergence_threshold=2,
        seed_convergence_threshold=2,
        seed_conc=0.05,
        max_levels=4,
        solve_conditions_list=conditions_list,
        timings=[], gate_log=[],
        cde=CDE(template_dir=template, cde_exec=get_cde_lite_exec(),
                sampling_seed=7, nrxn=4, radius=1))

    res = explore_network(exploremethod, solvemethod,
                          savedir=os.path.join(workdir, "out"), device=device)

    sd, rd = res.sd, res.rd
    print(f"\nExplored CRN: {sd.n} species, {rd.nr} reactions")
    u_final = np.asarray(res.sol.u)[-1]
    order = np.argsort(u_final)[::-1]
    print("Top species by final concentration:")
    for sid in order[:8]:
        if u_final[sid] > 1e-12:
            print(f"  {sd.toStr[sid]:24s} {u_final[sid]:.4g}")
    print(f"\nRun tree (restartable): {os.path.join(workdir, 'crn')}")
    return SimpleNamespace(res=res, em=exploremethod, sm=solvemethod,
                           conditions_list=conditions_list, workdir=workdir)


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
