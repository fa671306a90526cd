"""The port's ``solve_network`` against the JAX package's and scipy-BDF.

All six variants of the entry point (static / continuous / discrete rates
x complete / chunkwise integration) on ``synthetic_pyrolysis_network(5)``
under a 50 K/s ramp from 1000 K (static: 1000 K), each with one choice of
``linsolve`` and ``rhs_contraction`` so that every value of both runs:
the port with its accelerator algorithm (f32 Jacobian, the kernels' plain
versions on CPU), ``kinetica_tpu.solving.methods.solve_network`` with its
plain CPU settings (f64 LU, f64 Jacobian, f64 dot), which solve the same
ODE, and a pure-numpy scipy-BDF solve of the same formalism (for discrete
rates: segment by segment between the stops, k left-constant).

Tolerances: 1e-6 in mole fraction (all solves run at rtol 1e-8 / atol
1e-8 and differ in their linear algebra, so their errors are independent
tolerance-level errors); step counts within 20% of the JAX solve's (same
controller, different Newton linear solves).

The toy 6-species CRN of ``tests/test_solve_methods.py`` (46 steps) runs
every ``linsolve`` x ``rhs_contraction`` pairing against scipy, and once
against JAX's ``inv_fused`` with its Pallas kernels in interpret mode.
"""
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NC, X0, RATE, TF, CHUNK = 5, 1000.0, 50.0, 1.0, 0.25
RTOL, ATOL, K_MAX = 1e-8, 1e-8, 1e12
DEV = "cpu"

VARIANTS = {
    "static_complete": ("static", False, "auto", "auto"),
    "static_chunkwise": ("static", True, "inv_fused", "dd"),
    "continuous_complete": ("continuous", False, "inv_fused", "float64"),
    "continuous_chunkwise": ("continuous", True, "auto", "dd"),
    "discrete_complete": ("discrete", False, "auto", "float64"),
    "discrete_chunkwise": ("discrete", True, "inv_fused", "auto"),
}


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _dev(pkg):
    """The port's entry points default to the card; the CPU tests ask for
    the CPU (the JAX package's take no device)."""
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _problem(pkg, mode, chunks, linsolve="auto", contraction="auto"):
    import importlib
    syn = importlib.import_module(f"{pkg}.testing.synthetic")
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    prof_m = importlib.import_module(f"{pkg}.conditions.profiles")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    meth_m = importlib.import_module(f"{pkg}.solving.methods")
    sd, rd, Ea, A = syn.synthetic_pyrolysis_network(NC)
    calc = calc_m.PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX,
                                                   **_dev(pkg))
    if mode == "static":
        cs = cs_m.ConditionSet({"T": X0})
        cls = meth_m.StaticODESolve
    else:
        cs = cs_m.ConditionSet({"T": prof_m.LinearGradientProfile(
            rate=RATE, X_start=X0, X_end=X0 + RATE * TF)},
            ts_update=0.1 if mode == "discrete" else None)
        cls = meth_m.VariableODESolve
    pars = par_m.ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{NC}": 1.0}, solve_chunks=chunks,
        solve_chunkstep=CHUNK, save_interval=CHUNK / 2 if chunks else TF / 10,
        low_k_cutoff="none", abstol=ATOL, reltol=RTOL, linsolve=linsolve,
        rhs_contraction=contraction)
    return meth_m, cls(pars, cs, calc), sd, rd


def _scipy_final(mode, sd, rd, method, u0):
    from scipy.integrate import solve_ivp
    from kinetica_tpu_torch.testing.cpu_reference import (
        build_numpy_mass_action, scipy_bdf_baseline, scipy_bdf_discrete_baseline)
    calc = method.calculator
    if mode == "static":
        k = calc(X0).numpy()
        rhs_f, jac_f = build_numpy_mass_action(sd, rd)
        sol = solve_ivp(rhs_f(lambda t: k), (0.0, TF), u0, method="BDF",
                        jac=jac_f(lambda t: k), rtol=RTOL, atol=ATOL)
        return sol.y[:, -1]
    prof = method.conditions.get_profile("T")
    if mode == "continuous":
        return scipy_bdf_baseline(sd, rd, calc, prof, (0.0, TF), u0, RTOL,
                                  ATOL, best_of=1)[1]
    return scipy_bdf_discrete_baseline(sd, rd, calc, prof, (0.0, TF), u0,
                                       RTOL, ATOL, method.conditions.get_tstops())


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    from kinetica_tpu_torch.ops import dd_contract, fused_rhs, newton_solve
    mode, chunks, linsolve, contraction = VARIANTS[request.param]
    jm, jmethod, jsd, jrd = _problem("kinetica_tpu", mode, chunks)
    logging.disable(logging.INFO)
    ref = jm.solve_network(jmethod, jsd, jrd)
    tm, method, sd, rd = _problem("kinetica_tpu_torch", mode, chunks,
                                  linsolve, contraction)
    fused_rhs.launches = dd_contract.launches = newton_solve.launches = 0
    out = tm.solve_network(method, sd, rd, device=DEV)
    launches = fused_rhs.launches + dd_contract.launches + newton_solve.launches
    final = _scipy_final(mode, sd, rd, method, out.sol.u[0])
    return dict(name=request.param, mode=mode, ref=ref, out=out, final=final,
                launches=launches)


def test_succeeds_with_the_saved_grid(variant):
    out, ref = variant["out"], variant["ref"]
    assert out.sol.success, out.sol.retcode
    assert out.sol.u.shape == ref.sol.u.shape
    np.testing.assert_allclose(out.sol.t, ref.sol.t, rtol=0, atol=1e-15)
    assert np.all(np.isfinite(out.sol.u))
    assert variant["launches"] == 0          # CPU: the plain versions


def test_matches_jax_solve_network(variant):
    out, ref = variant["out"], variant["ref"]
    err = np.max(np.abs(out.sol.u - ref.sol.u))
    assert err <= 1e-6, err
    if variant["mode"] != "static":
        np.testing.assert_allclose(out.sol.vcs["T"], ref.sol.vcs["T"],
                                   rtol=1e-14)
    if variant["mode"] == "discrete":
        np.testing.assert_array_equal(out.sol.k.t, ref.sol.k.t)
        np.testing.assert_allclose(out.sol.k.u, ref.sol.k.u, rtol=1e-14)
    else:
        assert out.sol.k is None


def test_steps_close_to_jax(variant):
    s_t = variant["out"].sol.stats["n_steps"]
    s_j = variant["ref"].sol.stats["n_steps"]
    assert abs(s_t - s_j) <= 0.2 * s_j, (s_t, s_j)


def test_matches_scipy_bdf(variant):
    err = np.max(np.abs(variant["out"].sol.u[-1] - variant["final"]))
    assert err <= 1e-6, err


# ---- the toy CRN: every linear solve and contraction ----

def _toy(pkg, **kw):
    import importlib
    sd_m = importlib.import_module(f"{pkg}.core.network")
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    meth_m = importlib.import_module(f"{pkg}.solving.methods")
    sd = sd_m.SpeciesData(["C", "[H]", "[CH3]", "[H][H]", "CC", "C=C"])
    rd = sd_m.RxData.from_reactions(
        sd,
        reacs=[["C"], ["[CH3]", "[H]"], ["C", "[H]"], ["[CH3]", "[CH3]"],
               ["CC"], ["CC"]],
        prods=[["[CH3]", "[H]"], ["C"], ["[CH3]", "[H][H]"], ["CC"],
               ["C=C", "[H][H]"], ["[CH3]", "[CH3]"]],
        dH=[4.5, -4.5, 0.1, -3.8, 1.5, 3.8])
    calc = calc_m.PrecalculatedArrheniusCalculator(
        np.array([3.6e5, 0.0, 4.0e4, 0.0, 3.2e5, 3.5e5]),
        np.array([1e-8, 1e-12, 1e-13, 1e-12, 1e-7, 1e-8]), k_max=1e12,
        **_dev(pkg))
    kw = dict(dict(tspan=(0.0, 10.0), u0={"C": 1.0}, solve_chunks=False,
                   save_interval=0.5, low_k_cutoff="none"), **kw)
    pars = par_m.ODESimulationParams(**kw)
    return meth_m, meth_m.StaticODESolve(pars, cs_m.ConditionSet({"T": 900.0}),
                                         calc), sd, rd


def _toy_scipy(sd, rd, method, t_eval):
    from scipy.integrate import solve_ivp
    from kinetica_tpu_torch.testing.cpu_reference import build_numpy_mass_action
    k = method.calculator(900.0).numpy()
    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    u0 = np.zeros(sd.n)
    u0[sd.toInt["C"]] = 1.0
    return solve_ivp(rhs_f(lambda t: k), (0.0, 10.0), u0, method="BDF",
                     jac=jac_f(lambda t: k), rtol=1e-10, atol=1e-12,
                     t_eval=t_eval).y.T


@pytest.mark.parametrize("linsolve,contraction", [
    ("auto", "auto"), ("lu", "fused"), ("inv", "dd"), ("inv_gated", "float64"),
    ("inv_fused", "fused"), ("inv_fused", "dd"), ("inv_fused", "float64"),
    ("lu", "auto")])
def test_toy_every_linsolve_and_contraction(linsolve, contraction):
    tm, method, sd, rd = _toy("kinetica_tpu_torch", linsolve=linsolve,
                              rhs_contraction=contraction)
    out = tm.solve_network(method, sd, rd, device=DEV)
    assert out.sol.success
    ref = _toy_scipy(sd, rd, method, out.sol.t)
    assert np.max(np.abs(out.sol.u - ref)) <= 1e-6


def test_toy_autodiff_jacobian():
    """``pars.jac=False``: the Newton Jacobian is the forward-mode
    derivative of the mass-action RHS instead of the analytic one."""
    tm, method, sd, rd = _toy("kinetica_tpu_torch", jac=False)
    out = tm.solve_network(method, sd, rd, device=DEV)
    assert out.sol.success
    assert np.max(np.abs(out.sol.u - _toy_scipy(sd, rd, method,
                                                 out.sol.t))) <= 1e-6


def test_toy_inv_fused_matches_jax_interpret():
    """JAX's inv_fused runs its Gauss-Jordan and Newton-solve Pallas
    kernels in interpret mode on the CPU; the port its plain versions."""
    jm, jmethod, jsd, jrd = _toy("kinetica_tpu", linsolve="inv_fused")
    ref = jm.solve_network(jmethod, jsd, jrd)
    tm, method, sd, rd = _toy("kinetica_tpu_torch", linsolve="inv_fused")
    out = tm.solve_network(method, sd, rd, device=DEV)
    assert np.max(np.abs(out.sol.u - ref.sol.u)) <= 1e-6
    s_t, s_j = out.sol.stats["n_steps"], ref.sol.stats["n_steps"]
    assert abs(s_t - s_j) <= 0.2 * s_j, (s_t, s_j)


def test_toy_chunk_warm_start_honoured():
    """With chunk_warm_start (the default) each chunk resumes the previous
    chunk's order and difference array; without it each chunk restarts at
    order 1 from the carried h. Both solve the same ODE."""
    kw = dict(solve_chunks=True, solve_chunkstep=0.5)
    tm, m_warm, sd, rd = _toy("kinetica_tpu_torch", **kw)
    warm = tm.solve_network(m_warm, sd, rd, device=DEV)
    _, m_cold, sd, rd = _toy("kinetica_tpu_torch", chunk_warm_start=False, **kw)
    cold = tm.solve_network(m_cold, sd, rd, device=DEV)
    ref = _toy_scipy(sd, rd, m_warm, warm.sol.t)
    for res in (warm, cold):
        assert res.sol.success and res.sol.stats["n_chunks"] == 20
        assert np.max(np.abs(res.sol.u - ref)) <= 1e-6
    assert warm.sol.stats["n_steps"] < cold.sol.stats["n_steps"]


def test_toy_return_integrator_solves_a_segment():
    tm, method, sd, rd = _toy("kinetica_tpu_torch")
    integ = tm.solve_network(method, sd, rd, return_integrator=True,
                             device=DEV)
    res = integ.solve_segment(0.0, 10.0, [5.0, 10.0])
    assert int(res.status[0]) == 1
    ref = _toy_scipy(sd, rd, method, np.array([5.0, 10.0]))
    assert np.max(np.abs(res.ys[0].numpy() - ref)) <= 1e-6


def test_rk45_is_not_ported():
    tm, method, sd, rd = _toy("kinetica_tpu_torch", solver="rk45")
    with pytest.raises(ValueError, match="rk45"):
        tm.solve_network(method, sd, rd, device=DEV)
