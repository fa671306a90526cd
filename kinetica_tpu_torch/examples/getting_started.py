"""Getting started: explore a CRN and simulate its kinetics on the card.

The port of ``examples/getting_started.py`` (the reference's
getting-started tutorial): define conditions -> simulation parameters ->
exploration parameters -> calculator, then run ``explore_network`` and
analyse the results.

    python -m kinetica_tpu_torch.examples.getting_started [--device cuda]

Uses the bundled mock CDE (``kinetica_tpu_torch/examples/mock_cde.py``) so
no external Fortran/xTB binaries are needed; swap ``cde_exec`` for a real
CDE build to sample real chemistry.
"""
from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

from kinetica_tpu_torch.analysis.io import save_output
from kinetica_tpu_torch.analysis.plotting import (conditionsplot,
                                                  finalconcplot, plot_solution)
from kinetica_tpu_torch.conditions.condition_set import ConditionSet
from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
from kinetica_tpu_torch.core.network import format_rxn
from kinetica_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from kinetica_tpu_torch.examples import parser
from kinetica_tpu_torch.exploration import CDE, DirectExplore, explore_network
from kinetica_tpu_torch.solving.methods import VariableODESolve
from kinetica_tpu_torch.solving.params import ODESimulationParams
# the toy on-the-fly calculator, one shared (Ea, A) for every reaction;
# real workflows use PrecalculatedArrheniusCalculator or the ASE-NEB TST
# calculator
from kinetica_tpu_torch.testing.explore_config import UniformArrhenius

MOCK_CDE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mock_cde.py")


def main(workdir: str | None = None, device=DEFAULT_DEVICE):
    """Run the example under ``workdir`` (a new temporary directory by
    default); returns ``res`` (the explored and solved network), ``workdir``
    and ``results`` (the saved ``.npz``)."""
    device = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="kinetica_getting_started_")
    print(f"Working in {workdir}")

    # 1. Conditions: 500 -> 1200 K linear ramp at 50 K/s
    conditions = ConditionSet({
        "T": LinearGradientProfile(rate=50.0, X_start=500.0, X_end=1200.0)})

    # 2. Simulation parameters
    pars = ODESimulationParams(
        tspan=(0.0, conditions.get_t_final()),
        u0={"CC": 1.0},
        solve_chunks=True, solve_chunkstep=0.5)

    # 3. Exploration parameters (mock CDE)
    template = os.path.join(workdir, "template")
    os.makedirs(template)
    with open(os.path.join(template, "input"), "w") as fh:
        fh.write("pestype mock\n")
    exploremethod = DirectExplore(
        rdir_head=os.path.join(workdir, "crn"),
        reac_smiles=["CC"],
        rxn_convergence_threshold=3,
        cde=CDE(template_dir=template, cde_exec=MOCK_CDE, sampling_seed=1))

    # 4. Calculator + solve method
    solvemethod = VariableODESolve(pars, conditions,
                                   UniformArrhenius(device=device))

    # 5. Explore + simulate
    res = explore_network(exploremethod, solvemethod,
                          savedir=os.path.join(workdir, "out"), device=device)

    # 6. Analysis
    print(f"\nCRN: {res.sd.n} species, {res.rd.nr} reactions")
    for i in range(min(res.rd.nr, 8)):
        print("  ", format_rxn(res.sd, res.rd, i))
    print("final concentrations:",
          {res.sd.toStr[i]: round(float(res.sol.u[-1, i]), 4)
           for i in range(res.sd.n)})

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plot_solution(res, label_above=0.01)
        plt.savefig(os.path.join(workdir, "kinetics.png"), dpi=120)
        conditionsplot(res, "T")
        plt.savefig(os.path.join(workdir, "Tprofile.png"), dpi=120)
        finalconcplot(res, n_top=8)
        plt.savefig(os.path.join(workdir, "final_concs.png"), dpi=120)
        print(f"Plots written to {workdir}")
    except ImportError:
        print("matplotlib is not installed: plots skipped")

    results = os.path.join(workdir, "results.npz")
    save_output(res, results)
    print(f"Results saved to {results}")
    return SimpleNamespace(res=res, workdir=workdir, results=results)


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
