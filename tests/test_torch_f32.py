"""The port's float32 state path against the JAX package's.

``pars.dtype="float32"`` keeps the state, the RHS (the plain f32 dot) and
the rates in f32, time and step size in f64, as the reference does. The
cases of ``tests/test_solve_methods.py::test_float32_state_dtype_solves``
(nc=6, abstol 1e-6, reltol 1e-4): ``solve_network`` and the discrete
ensemble agree with the JAX package's f32 solves within 1e-4, the
continuous ensemble (which the JAX package cannot run in f32) with its
own f64 solve within 1e-4, ``solve_network_ensemble`` with the single
solve; and on the
shorter horizon of ``tests/test_f32_drift.py`` (nc=8, tf=100 s) the port's
f32 solve stays within 5e-5 of its own f64 solve, the reference's bound.
``inv_fused`` and the f64 RHS kernels refuse an f32 state.
"""
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _mods(pkg):
    import importlib
    names = ("calculators.builtin", "conditions.condition_set",
             "conditions.profiles", "solving.params", "solving.methods",
             "parallel.batching", "testing.synthetic")
    return {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
            for n in names}


def _dev(pkg):
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _case(pkg, **par_kw):
    m = _mods(pkg)
    sd, rd, Ea, A = m["synthetic"].synthetic_pyrolysis_network(6)
    calc = m["builtin"].PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12,
                                                         **_dev(pkg))

    def mk(r):
        return m["condition_set"].ConditionSet({"T": m["profiles"]
                                                .LinearGradientProfile(
            rate=r, X_start=500.0, X_end=500.0 + r * 4)}, ts_update=0.25)
    kw = dict(tspan=(0.0, 4.0), u0={"C6": 1.0}, solve_chunks=True,
              solve_chunkstep=1.0, low_k_cutoff="none", dtype="float32",
              abstol=1e-6, reltol=1e-4)
    kw.update(par_kw)
    pars = m["params"].ODESimulationParams(**kw)
    return m, sd, rd, calc, pars, mk


def test_solve_network_f32_matches_jax():
    out = {}
    for pkg in ("kinetica_tpu", "kinetica_tpu_torch"):
        m, sd, rd, calc, pars, mk = _case(pkg)
        out[pkg] = m["methods"].solve_network(
            m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
            **_dev(pkg)).sol
    ref, sol = out["kinetica_tpu"], out["kinetica_tpu_torch"]
    assert sol.success and sol.u.dtype == np.float32
    assert sol.u.shape == ref.u.shape
    assert np.max(np.abs(sol.u - np.asarray(ref.u))) <= 1e-4


def test_discrete_ensemble_f32_matches_jax():
    out = {}
    for pkg in ("kinetica_tpu", "kinetica_tpu_torch"):
        m, sd, rd, calc, pars, mk = _case(pkg)
        prob = m["batching"].EnsembleProblem(
            m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
            **_dev(pkg))
        out[pkg] = prob.solve(conditions_list=[mk(55.0), mk(60.0)])
    ref, ens = out["kinetica_tpu"], out["kinetica_tpu_torch"]
    assert ens.success and ens.u.shape == np.asarray(ref.u).shape
    assert np.max(np.abs(ens.u - np.asarray(ref.u))) <= 1e-4


def test_continuous_ensemble_f32_against_own_f64():
    """The JAX package's continuous-rate ensemble fails an f32 state at
    trace time (a while_loop carry of f32 state and f64 rates), so the
    port's is held to its own f64 solve, within the f32 solve's reltol
    (1e-4 on concentrations of order 1)."""
    out = {}
    for kw in (dict(dtype="float64", abstol=1e-10, reltol=1e-8), {}):
        m, sd, rd, calc, pars, mk = _case("kinetica_tpu_torch", **kw)
        prob = m["batching"].EnsembleProblem(
            m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
            rate_mode="continuous", device="cpu")
        out[pars.dtype] = prob.solve(conditions_list=[mk(55.0), mk(60.0)])
    assert out["float32"].success and out["float64"].success
    assert out["float32"].u.shape == out["float64"].u.shape
    assert np.max(np.abs(out["float32"].u - out["float64"].u)) <= 1e-4


def test_solve_network_ensemble_f32():
    m, sd, rd, calc, pars, mk = _case("kinetica_tpu_torch")
    ens = m["batching"].solve_network_ensemble(
        m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
        conditions_list=[mk(60.0)], device="cpu")
    sol = m["methods"].solve_network(
        m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
        device="cpu").sol
    assert ens.success and ens.u.shape == (1,) + sol.u.shape
    assert np.max(np.abs(ens.u[0] - sol.u)) <= 1e-4


def _drift_case(dtype, tols):
    m = _mods("kinetica_tpu_torch")
    sd, rd, Ea, A = m["synthetic"].synthetic_pyrolysis_network(8)
    calc = m["builtin"].PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12,
                                                         device="cpu")
    tf, rate = 1e2, 4.0
    conds = m["condition_set"].ConditionSet({"T": m["profiles"]
                                             .LinearGradientProfile(
        rate=rate, X_start=700.0, X_end=700.0 + rate * tf)}, ts_update=tf / 40)
    pars = m["params"].ODESimulationParams(
        tspan=(0.0, tf), u0={"C8": 1.0}, solve_chunks=True,
        solve_chunkstep=tf / 100, abstol=tols[0], reltol=tols[1],
        low_k_cutoff="none", dtype=dtype)
    res = m["methods"].solve_network(
        m["methods"].VariableODESolve(pars, conds, calc), sd, rd, device="cpu")
    assert res.sol.success
    return res.sol.u


def test_f32_drift_against_own_f64():
    u64 = _drift_case("float64", (1e-10, 1e-8))
    u32 = _drift_case("float32", (1e-6, 1e-4))
    assert u32.dtype == np.float32
    assert np.abs(u32 - u64).max() < 5e-5


@pytest.mark.parametrize("knob", [dict(linsolve="inv_fused"),
                                  dict(rhs_contraction="fused"),
                                  dict(rhs_contraction="dd"),
                                  dict(dtype="float16")])
def test_f32_refuses_the_f64_kernels(knob):
    m, sd, rd, calc, pars, mk = _case("kinetica_tpu_torch", **knob)
    with pytest.raises(ValueError, match=next(iter(knob.values()))):
        m["methods"].solve_network(
            m["methods"].VariableODESolve(pars, mk(60.0), calc), sd, rd,
            device="cpu")
