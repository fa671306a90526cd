"""The port's steady-state finder against the JAX package's.

The cases of ``tests/test_steady_state.py``: the synthetic pyrolysis CRN
(nc=6, 800 K) single and as a 4-member temperature ensemble, where both
packages must reach the same fixed point (1e-8 absolute) in the same
number of epochs; the reversible isomerisation A <=> B, whose fixed point
and sensitivities are analytic; the interior equilibrium of three
isomers, where the port's sensitivities equal the JAX package's to 1e-8
relative; and the rejection of variable conditions. The port runs its
accelerator algorithm on the CPU (f32 Newton Jacobian, the Gauss-Jordan
kernel's plain version), the JAX package its CPU settings (f64 J, LU).
"""
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("kinetica_tpu", "kinetica_tpu_torch")


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _mods(pkg):
    import importlib
    names = ("core.network", "calculators.builtin", "conditions.condition_set",
             "conditions.profiles", "solving.params", "solving.methods",
             "solving.steady_state", "testing.synthetic", "constants")
    return {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
            for n in names}


def _dev(pkg):
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _pyrolysis(pkg, T=800.0):
    m = _mods(pkg)
    sd, rd, Ea, A = m["synthetic"].synthetic_pyrolysis_network(6)
    calc = m["builtin"].PrecalculatedArrheniusCalculator(Ea, A, k_max=1e6,
                                                         **_dev(pkg))
    pars = m["params"].ODESimulationParams(tspan=(0.0, 1.0), u0={"C6": 1.0},
                                           low_k_cutoff="none")
    cs = m["condition_set"].ConditionSet({"T": T})
    return m, sd, rd, calc, pars, cs


def test_single_matches_jax():
    res = {}
    for pkg in PKGS:
        m, sd, rd, calc, pars, cs = _pyrolysis(pkg)
        res[pkg] = m["steady_state"].find_steady_state(
            m["methods"].StaticODESolve(pars, cs, calc), sd, rd, t_first=0.1,
            max_epochs=16, **_dev(pkg))
    ref, out = res["kinetica_tpu"], res["kinetica_tpu_torch"]
    assert ref.converged and out.converged
    assert out.epochs == ref.epochs
    assert out.t_total == ref.t_total
    np.testing.assert_allclose(out.u, ref.u, rtol=0, atol=1e-8)
    assert out.residual < 1.0


def test_ensemble_matches_jax():
    Ts = [700.0, 800.0, 900.0, 1000.0]
    res = {}
    for pkg in PKGS:
        m, sd, rd, calc, pars, _ = _pyrolysis(pkg)
        conds = [m["condition_set"].ConditionSet({"T": T}) for T in Ts]
        res[pkg] = m["steady_state"].find_steady_state_ensemble(
            m["methods"].StaticODESolve(pars, conds[0], calc), sd, rd, conds,
            t_first=0.1, max_epochs=16, **_dev(pkg))
    ref, out = res["kinetica_tpu"], res["kinetica_tpu_torch"]
    assert ref.success and out.success
    assert out.u.shape == (4, sd.n)
    assert out.epochs == ref.epochs and out.t_total == ref.t_total
    np.testing.assert_array_equal(out.converged, ref.converged)
    np.testing.assert_allclose(out.u, ref.u, rtol=0, atol=1e-8)
    assert np.all(out.residual < 1.0)
    assert out.n_steps.shape == (out.epochs, 4) and np.all(out.n_steps > 0)


def _isomerisation(pkg):
    m = _mods(pkg)
    sd = m["network"].SpeciesData(["C=CC=C", "C#CCC"])
    rd = m["network"].RxData.from_reactions(sd, [["C=CC=C"], ["C#CCC"]],
                                            [["C#CCC"], ["C=CC=C"]])
    A = np.array([3.0, 1.0]) / m["constants"].N_A
    calc = m["builtin"].PrecalculatedArrheniusCalculator(np.zeros(2), A,
                                                         **_dev(pkg))
    pars = m["params"].ODESimulationParams(tspan=(0.0, 1.0),
                                           u0={"C=CC=C": 1.0},
                                           low_k_cutoff="none")
    method = m["methods"].StaticODESolve(
        pars, m["condition_set"].ConditionSet({"T": 500.0}), calc)
    return m, sd, rd, method


def test_isomerisation_analytic_and_sensitivities():
    """u*_B / u*_A = k_f / k_r = 3; du*_B / d ln k_f = k_f k_r / (k_f +
    k_r)^2 = 3/16; the port's S equals the JAX package's to 1e-8."""
    S = {}
    for pkg in PKGS:
        m, sd, rd, method = _isomerisation(pkg)
        res = m["steady_state"].find_steady_state(method, sd, rd, t_first=0.01,
                                                  **_dev(pkg))
        assert res.converged
        uA, uB = res.u[sd.toInt["C=CC=C"]], res.u[sd.toInt["C#CCC"]]
        np.testing.assert_allclose(uB / uA, 3.0, rtol=1e-6)
        np.testing.assert_allclose(uA + uB, 1.0, rtol=1e-8)
        S[pkg] = m["steady_state"].steady_state_sensitivities(
            method, sd, rd, result=res, **_dev(pkg))
    out = S["kinetica_tpu_torch"]
    iA, iB = sd.toInt["C=CC=C"], sd.toInt["C#CCC"]
    np.testing.assert_allclose(out[iB, 0], 3.0 / 16.0, rtol=1e-6)
    np.testing.assert_allclose(out[iA, 0], -3.0 / 16.0, rtol=1e-6)
    np.testing.assert_allclose(out.sum(axis=0), 0.0, atol=1e-12)
    np.testing.assert_allclose(out, S["kinetica_tpu"], rtol=1e-8,
                               atol=1e-8 * np.abs(S["kinetica_tpu"]).max())


def _three_isomers(pkg, A0):
    m = _mods(pkg)
    A_s, B_s, C_s = "C=CC=C", "C#CCC", "C1CC=1C"
    sd = m["network"].SpeciesData([A_s, B_s, C_s])
    rd = m["network"].RxData.from_reactions(
        sd, reacs=[[A_s], [B_s], [B_s], [C_s], [B_s, B_s], [A_s, C_s]],
        prods=[[B_s], [A_s], [C_s], [B_s], [A_s, C_s], [B_s, B_s]])
    calc = m["builtin"].PrecalculatedArrheniusCalculator(
        np.zeros(6), A0 / m["constants"].N_A, **_dev(pkg))
    pars = m["params"].ODESimulationParams(tspan=(0.0, 1.0), u0={A_s: 1.0},
                                           low_k_cutoff="none")
    method = m["methods"].StaticODESolve(
        pars, m["condition_set"].ConditionSet({"T": 500.0}), calc)
    return m, sd, rd, method


def test_interior_equilibrium_sensitivities_match_jax():
    A0 = np.array([2.0, 1.0, 1.5, 0.5, 0.8, 0.6])
    S, U = {}, {}
    for pkg in PKGS:
        m, sd, rd, method = _three_isomers(pkg, A0)
        res = m["steady_state"].find_steady_state(
            method, sd, rd, t_first=0.01, move_tol=1e-4, **_dev(pkg))
        assert res.converged
        U[pkg] = res.u
        S[pkg] = m["steady_state"].steady_state_sensitivities(
            method, sd, rd, result=res, **_dev(pkg))
    out, ref = S["kinetica_tpu_torch"], S["kinetica_tpu"]
    assert out.shape == (3, 6) and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(U["kinetica_tpu_torch"], U["kinetica_tpu"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.sum(axis=0), 0.0, atol=1e-10)
    np.testing.assert_allclose(out, ref, rtol=1e-8,
                               atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize("which", ["single", "ensemble", "sensitivities"])
def test_rejects_variable_conditions(which):
    m = _mods("kinetica_tpu_torch")
    sd, rd, Ea, A = m["synthetic"].synthetic_pyrolysis_network(4)
    calc = m["builtin"].PrecalculatedArrheniusCalculator(Ea, A, device="cpu")
    ramp = m["condition_set"].ConditionSet({"T": m["profiles"].LinearGradientProfile(
        rate=10.0, X_start=500.0, X_end=600.0)})
    pars = m["params"].ODESimulationParams(tspan=(0.0, 10.0), u0={"C4": 1.0},
                                           low_k_cutoff="none")
    ss = m["steady_state"]
    if which == "ensemble":
        static = m["methods"].StaticODESolve(
            pars, m["condition_set"].ConditionSet({"T": 700.0}), calc)
        with pytest.raises(TypeError, match="static"):
            ss.find_steady_state_ensemble(static, sd, rd, [ramp], device="cpu")
        return
    method = m["methods"].VariableODESolve(pars, ramp, calc)
    fn = (ss.find_steady_state if which == "single"
          else ss.steady_state_sensitivities)
    with pytest.raises(TypeError, match="StaticODESolve"):
        fn(method, sd, rd, device="cpu")
