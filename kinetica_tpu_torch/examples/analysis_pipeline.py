"""The production analysis pipeline on one CRN, end to end, on the card.

The port of ``examples/analysis_pipeline.py``. Screen -> quantify ->
reduce -> inspect, on the 108-reaction synthetic cracking network (every
stage batches on the ensemble solver):

  1. Morris elementary-effects screening: which of the 108 rate
     constants does the ethene yield respond to at all?
  2. Sobol indices on the Morris survivors: how much variance does each
     explain, alone (S1) and with interactions (ST)?
  3. DRGEP skeletal reduction: the smallest sub-mechanism that
     reproduces the target profiles within tolerance, validated by
     re-solves.
  4. Reaction-flux analysis of the full solution: where the ethene
     actually comes from.

    python -m kinetica_tpu_torch.examples.analysis_pipeline [--device cuda]
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from kinetica_tpu_torch import (ConditionSet, ODESimulationParams,
                                PrecalculatedArrheniusCalculator,
                                StaticODESolve, morris_screening,
                                reduce_network_drg, sobol_sensitivity,
                                solve_network)
from kinetica_tpu_torch.analysis.flux import reaction_fluxes
from kinetica_tpu_torch.core.network import format_rxn
from kinetica_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from kinetica_tpu_torch.examples import parser
from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

TARGET = "C2e"          # ethene yield is the observable throughout


def main(n_carbons: int = 6, device=DEFAULT_DEVICE):
    """Run the four stages on ``synthetic_pyrolysis_network(n_carbons)``;
    returns each stage's result (``full``, ``scr``, ``survivors``, ``sob``,
    ``red``, ``refused`` (the trapezoid attribution's message) and
    ``flux``) with the network and the method."""
    device = resolve_device(device)
    sd, rd, Ea, A = synthetic_pyrolysis_network(n_carbons)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=device)
    pars = ODESimulationParams(tspan=(0.0, 2.0), u0={f"C{n_carbons}": 1.0},
                               solve_chunks=True, solve_chunkstep=0.5,
                               save_interval=0.01)
    method = StaticODESolve(pars, ConditionSet({"T": 1100.0}), calc)
    print(f"CRN: {rd.nr} reactions / {sd.n} species, objective = "
          f"final [{TARGET}] at 1100 K")

    # 0. the full reference solution (reused by every later stage)
    full = solve_network(method, sd, rd, device=device)
    u = np.asarray(full.sol.u)
    print(f"full solve: final [{TARGET}] = {u[-1, sd.toInt[TARGET]]:.4f}\n")

    # 1. Morris screen over every rate constant (one batched sweep)
    scr = morris_screening(method, sd, rd, objective=TARGET,
                           n_trajectories=4, span_decades=1.0, seed=7,
                           device=device)
    print(scr.summarise(sd, rd, top=8))
    survivors = scr.ranking()[:6]
    print(f"-> carrying the top {len(survivors)} into Sobol\n")

    # 2. Sobol indices on the survivors (one batched sweep)
    sob = sobol_sensitivity(method, sd, rd, rids=survivors,
                            objective=TARGET, n_samples=32,
                            span_decades=1.0, seed=7, device=device)
    print(sob.summarise(sd, rd))
    print()

    # 3. DRGEP skeletal reduction, error-controlled by re-solves
    red = reduce_network_drg(method, sd, rd, targets=[TARGET],
                             tol=1e-3, method="drgep", full_output=full,
                             eps_ladder=np.geomspace(0.3, 0.12, 8),
                             device=device)
    print(red.summary())
    print()

    # 4. flux decomposition. The saturated feed conversion is a
    # sub-grid ignition burst, so the plain trapezoid attribution
    # REFUSES (its extents would be grid artifacts):
    refused = None
    try:
        reaction_fluxes(full, calc=calc)
    except ValueError as exc:
        refused = str(exc)
        print(f"trapezoid flux attribution correctly refused:\n  {exc}\n")
    # ... the projected attribution reconstructs every save interval's
    # NET species change exactly, so extents stay meaningful across
    # the burst:
    flux = reaction_fluxes(full, calc=calc, attribution="projected")
    print("top channels by net-consistent integrated extent:")
    for rid, extent in flux.top(4):
        print(f"  {extent:10.3e}  {format_rxn(sd, rd, int(rid))}")
    return SimpleNamespace(sd=sd, rd=rd, calc=calc, method=method, full=full,
                           scr=scr, survivors=survivors, sob=sob, red=red,
                           refused=refused, flux=flux)


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
