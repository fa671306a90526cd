"""The port's batched variable-T sweep against the JAX package, end to end.

Same network (``synthetic_pyrolysis_network(6)``), same four temperature
ramps (40-60 K/s from 1000 K, so the feed burns), same tolerances, through
``kinetica_tpu.parallel.batching.EnsembleProblem`` (CPU, continuous rates,
async chunks, its CPU defaults: f64 LU, f64 Jacobian) and
``kinetica_tpu_torch.parallel.batching.EnsembleProblem`` (its accelerator
algorithm with the kernels' plain versions on CPU). Lane 0 is also held
against the port's pure-numpy scipy-BDF baseline.

Tolerances: 1e-6 in mole fraction (both solvers run at rtol 1e-8 / atol
1e-10 and differ in their linear algebra, so their errors are independent
tolerance-level errors); per-lane step counts within 20% (same controller,
different Newton linear solves).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NC, B, TF, CHUNK = 6, 4, 2.0, 0.5
RTOL, ATOL, K_MAX, X0 = 1e-8, 1e-10, 1e12, 1000.0


def _dev(pkg):
    """The port's entry points default to the card; the CPU tests ask for
    the CPU (the JAX package's take no device)."""
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _setup(pkg):
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
    conds = [cs_m.ConditionSet({"T": prof_m.LinearGradientProfile(
        rate=float(r), X_start=X0, X_end=X0 + float(r) * TF)})
        for r in np.linspace(40.0, 60.0, B)]
    pars = par_m.ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
        jac_policy="lazy", lu_drift_tol=0.3)
    method = meth_m.VariableODESolve(pars, conds[0], calc)
    return sd, rd, calc, conds, pars, method


@pytest.fixture(scope="module")
def solves():
    from kinetica_tpu.parallel.batching import EnsembleProblem as JaxEP
    from kinetica_tpu_torch.ops import fused_rhs, gj_inverse
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem

    sd, rd, _, conds, _, method = _setup("kinetica_tpu")
    jax_ens = JaxEP(method, sd, rd, rate_mode="continuous",
                    chunk_mode="async").solve(conditions_list=conds)

    sd_t, rd_t, calc_t, conds_t, pars_t, method_t = _setup("kinetica_tpu_torch")
    fused_rhs.launches = gj_inverse.launches = 0
    ep = EnsembleProblem(method_t, sd_t, rd_t, rate_mode="continuous",
                         chunk_mode="async", device="cpu")
    ens = ep.solve(conditions_list=conds_t)
    return jax_ens, ens, (sd_t, rd_t, calc_t, conds_t, pars_t)


def test_all_lanes_done(solves):
    jax_ens, ens, _ = solves
    assert jax_ens.success
    assert ens.success, ens.retcodes
    assert ens.u.shape == jax_ens.u.shape == (B, 1 + int(TF / CHUNK), 19)
    assert np.all(np.isfinite(ens.u))


def test_chemistry_moves(solves):
    _, ens, (sd, *_rest) = solves
    feed = sd.toInt[f"C{NC}"]
    assert np.all(ens.u[:, -1, feed] <= 0.99 * ens.u[:, 0, feed])


def test_matches_jax_ensemble(solves):
    jax_ens, ens, _ = solves
    np.testing.assert_allclose(ens.t, jax_ens.t, rtol=0, atol=1e-15)
    total = ens.u[:, :1].sum(axis=2, keepdims=True)
    err = np.max(np.abs(ens.u - jax_ens.u) / np.maximum(total, 1.0))
    assert err <= 1e-6, err
    np.testing.assert_allclose(ens.vcs["T"], jax_ens.vcs["T"], rtol=1e-14)


def test_step_counts_close_to_jax(solves):
    jax_ens, ens, _ = solves
    s_t = np.asarray(ens.stats["n_steps"], float)
    s_j = np.asarray(jax_ens.stats["n_steps"], float)
    assert np.all(np.abs(s_t - s_j) <= 0.2 * s_j), (s_t, s_j)


def test_lane0_matches_scipy_baseline(solves):
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_baseline
    _, ens, (sd, rd, calc, conds, pars) = solves
    _, final = scipy_bdf_baseline(sd, rd, calc, conds[0].get_profile("T"),
                                  pars.tspan, make_u0(sd, pars), RTOL, ATOL,
                                  best_of=1)
    err = np.max(np.abs(ens.u[0, -1] - final) / max(final.sum(), 1.0))
    assert err <= 1e-6, err


def test_cpu_run_launches_no_kernel(solves):
    from kinetica_tpu_torch.ops import fused_rhs, gj_inverse
    assert fused_rhs.launches == 0 and gj_inverse.launches == 0


def test_failed_lanes_retry_compacted(solves):
    """Lanes 1 and 3 start from NaN and fail on every attempt: they are
    retried alone, in a compacted batch of 2, with tolerances tightened
    x10 per attempt up to the limit of 5 attempts. Lanes 0 and 2 keep
    their first answer, which a NaN neighbour does not disturb."""
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    _, ens, (sd, rd, calc, conds, pars) = solves
    u0s = np.tile(make_u0(sd, pars), (B, 1))
    u0s[[1, 3]] = np.nan
    ep = EnsembleProblem(VariableODESolve(pars, conds[0], calc), sd, rd,
                         rate_mode="continuous", chunk_mode="async",
                         device="cpu")
    res = ep.solve(conditions_list=conds, u0s=u0s)
    assert [r == "Success" for r in res.retcodes] == [True, False, True, False]
    assert res.stats["attempts"] == 5 and res.stats["retry_batch"] == 2
    np.testing.assert_allclose(res.stats["abstol"], [ATOL, ATOL * 1e-4] * 2,
                               rtol=1e-12)
    np.testing.assert_array_equal(res.u[[0, 2]], ens.u[[0, 2]])


@pytest.mark.parametrize("n_failed,B,Br", [(1, 64, 1), (3, 64, 4), (5, 8, 8),
                                           (33, 64, 64), (6, 6, 6)])
def test_retry_batch_size(n_failed, B, Br):
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    assert EnsembleProblem._retry_batch_size(n_failed, B) == Br
