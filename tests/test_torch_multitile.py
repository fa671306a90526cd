"""The multi-tile width (129-512 species) end to end, at small size.

``synthetic_pyrolysis_network(60, target_reactions=300)`` has 181 species,
the width of the nc=60 benchmark network (the network of
``tests/test_grad_multitile.py``): its Newton factor goes through the
block-Schur inverse (128 + 53). Static 900 K, ``k_max=1e4``, tf = 2e-4 s (about 140 steps).

- the port's ``solve_network`` (``linsolve="inv_gated"``) against the JAX
  package's with the same settings (its Pallas kernels in interpret mode):
  final state within 1e-7 of max |u| (both run the same algorithm in f32
  and f64; the differences are rounding, amplified by the stepper);
- ``jac_policy="always"`` against ``"lazy"`` in the port (1e-7), and its
  counters: one J and one factor per step attempt;
- the port's continuous ensemble at B=16 under 16 ramps against its own
  per-lane ``solve_network`` on three lanes (1e-7): batching must not
  couple lanes;
- the stale-J refresh of a sweep (nc=5, four ramps from 750-1000 K whose
  lanes fail their Newton iterations on a stale J at different steps):
  it is counted once per refresh and a refresh serves only the lanes
  that failed, fewer than the batch;
- ``resolve_linsolve``: "auto" is "inv_gated" up to 512 species and "lu"
  above; an explicit inverse method above 512 raises.
"""
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NC, NR, TF, T_K, K_MAX = 60, 300, 2e-4, 900.0, 1e4


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _dev(pkg):
    """The port's entry points default to the card; the CPU tests ask for
    the CPU (the JAX package's take no device)."""
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _static(pkg, **par_kw):
    import importlib
    syn = importlib.import_module(f"{pkg}.testing.synthetic")
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    meth_m = importlib.import_module(f"{pkg}.solving.methods")
    sd, rd, Ea, A = syn.synthetic_pyrolysis_network(NC, target_reactions=NR)
    calc = calc_m.PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX,
                                                   **_dev(pkg))
    pars = par_m.ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{NC}": 1.0}, solve_chunks=False,
        low_k_cutoff="none", save_interval=TF / 2, linsolve="inv_gated",
        **par_kw)
    out = meth_m.solve_network(
        meth_m.StaticODESolve(pars, cs_m.ConditionSet({"T": T_K}), calc),
        sd, rd, **_dev(pkg))
    assert sd.n == 181 and out.sol.success
    return out.sol


def _close(a, b, tol=1e-7):
    return np.abs(np.asarray(a) - np.asarray(b)).max() <= tol * np.abs(b).max()


@pytest.fixture(scope="module")
def port_lazy():
    return _static("kinetica_tpu_torch")


def test_solve_network_matches_jax(port_lazy):
    """Before the block-Schur inverse the port raised here, at its first
    factor."""
    ref = _static("kinetica_tpu")
    assert _close(port_lazy.u, ref.u)
    assert abs(port_lazy.stats["n_steps"] - ref.stats["n_steps"]) <= (
        0.2 * ref.stats["n_steps"])


def test_jac_policy_always(port_lazy):
    sol = _static("kinetica_tpu_torch", jac_policy="always")
    assert _close(sol.u, port_lazy.u)
    st = sol.stats
    # the initial J and factor, then one of each per step attempt
    assert st["n_jev"] == st["n_lu"] == st["n_steps"] + 1
    assert port_lazy.stats["n_jev"] < port_lazy.stats["n_lu"] < st["n_lu"]


def test_ensemble_matches_per_lane_solves():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(NC, target_reactions=NR)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device="cpu")
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=T_K, X_end=T_K + float(r) * TF)})
        for r in np.linspace(1e5, 1e6, 16)]
    pars = ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=TF / 2, low_k_cutoff="none", linsolve="inv_gated")
    ens = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                          rate_mode="continuous", device="cpu").solve(
                              conditions_list=conds)
    assert ens.success
    for b in (0, 7, 15):
        out = solve_network(VariableODESolve(pars, conds[b], calc), sd, rd,
                            device="cpu")
        assert _close(ens.u[b], out.sol.u)


def test_stale_jacobian_refresh_serves_failed_lanes():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.ops import bdf
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(5)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e10, device="cpu")
    tf, B = 0.5, 4
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=50.0, X_start=float(x), X_end=float(x) + 50.0 * tf)})
        for x in np.linspace(750.0, 1000.0, B)]
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={"C5": 1.0}, solve_chunks=True,
        solve_chunkstep=tf / 2, low_k_cutoff="none", abstol=1e-10,
        reltol=1e-8, lu_drift_tol=0.3)
    bdf.jac_refreshes = 0
    ens = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                          rate_mode="continuous", device="cpu").solve(
                              conditions_list=conds)
    assert ens.success and ens.stats["attempts"] == 1
    # each lane evaluates J once at its start; the rest are refreshes
    lanes = int(np.asarray(ens.stats["n_jev"]).sum()) - B
    assert 0 < bdf.jac_refreshes <= lanes < B * bdf.jac_refreshes


@pytest.mark.parametrize("ns,want", [(73, "inv_gated"), (181, "inv_gated"),
                                     (512, "inv_gated"), (513, "lu"),
                                     (600, "lu")])
def test_resolve_auto_by_width(ns, want):
    from kinetica_tpu_torch.ops.linalg import resolve_linsolve
    assert resolve_linsolve("auto", ns) == want
    assert resolve_linsolve("lu", ns) == "lu"


@pytest.mark.parametrize("method", ["inv", "inv_gated", "inv_fused"])
def test_explicit_inverse_above_512_raises(method):
    from kinetica_tpu_torch.ops.linalg import resolve_linsolve
    assert resolve_linsolve(method, 512) == method
    with pytest.raises(ValueError, match="512"):
        resolve_linsolve(method, 513)
