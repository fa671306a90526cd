"""The discrete rate mode of the port's ensemble against the JAX package.

Four 40-60 K/s ramps from 1000 K with rate updates every 0.1 s on
``synthetic_pyrolysis_network(5)``, 4 chunks of 0.25 s, through both
packages' ``EnsembleProblem`` with their default rate and chunk modes:
the JAX package on the CPU (discrete, scan chunks, f64 LU), the port
(discrete, async chunks, its accelerator algorithm with the kernels'
plain versions). Every member is held to the JAX ensemble and member 0 to
the pure-numpy scipy-BDF discrete reference (segment by segment between
the stops, k left-constant). Tolerance 1e-6 in mole fraction, as
tests/test_torch_slice.py. The left-constant lookup and the k tables are
held to the JAX package's exactly / to 1e-14 relative.
"""
import inspect
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NC, B, TF, CHUNK, TS = 5, 4, 1.0, 0.25, 0.1
RTOL, ATOL, K_MAX, X0 = 1e-8, 1e-8, 1e12, 1000.0


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _dev(pkg):
    """The port's entry points default to the card; the CPU tests ask for
    the CPU (the JAX package's take no device)."""
    return {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}


def _setup(pkg, **kw):
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
        rate=float(r), X_start=X0, X_end=X0 + float(r) * TF)}, ts_update=TS)
        for r in np.linspace(40.0, 60.0, B)]
    pars = par_m.ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
        lu_drift_tol=0.3, **kw)
    return sd, rd, calc, conds, pars, meth_m.VariableODESolve(pars, conds[0],
                                                               calc)


@pytest.fixture(scope="module")
def solves():
    from kinetica_tpu.parallel.batching import EnsembleProblem as JaxEP
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    sd, rd, _, conds, _, method = _setup("kinetica_tpu")
    jax_ens = JaxEP(method, sd, rd).solve(conditions_list=conds)
    setup = _setup("kinetica_tpu_torch")
    sd_t, rd_t, _, conds_t, _, method_t = setup
    ens = EnsembleProblem(method_t, sd_t, rd_t, device="cpu").solve(
        conditions_list=conds_t)
    return jax_ens, ens, setup


def test_all_members_done(solves):
    jax_ens, ens, _ = solves
    assert jax_ens.success and ens.success, ens.retcodes
    assert ens.u.shape == jax_ens.u.shape == (B, 1 + int(TF / CHUNK), 16)
    np.testing.assert_array_equal(ens.t, jax_ens.t)


def test_members_match_jax_discrete_ensemble(solves):
    jax_ens, ens, _ = solves
    assert np.max(np.abs(ens.u - jax_ens.u)) <= 1e-6
    np.testing.assert_allclose(ens.vcs["T"], jax_ens.vcs["T"], rtol=1e-14)


def test_member0_matches_scipy_discrete_reference(solves):
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_discrete_baseline)
    _, ens, (sd, rd, calc, conds, pars, _) = solves
    final = scipy_bdf_discrete_baseline(
        sd, rd, calc, conds[0].get_profile("T"), pars.tspan, make_u0(sd, pars),
        RTOL, ATOL, conds[0].get_tstops())
    assert np.max(np.abs(ens.u[0, -1] - final)) <= 1e-6


def test_k_tables_input_equals_conditions_input(solves):
    """Given tables, u0s fanned out from one member: lanes 0 and 1 run
    member 0's table and give its answer."""
    from kinetica_tpu_torch.parallel.batching import (EnsembleProblem,
                                                      build_condition_sweep)
    _, ens, (sd, rd, calc, conds, pars, method) = solves
    tstops, k_tables = build_condition_sweep(conds, calc, rd.nr, pars)
    u0 = ens.u[0, 0]
    res = EnsembleProblem(method, sd, rd, device="cpu").solve(
        k_tables=k_tables[:1], tstops=tstops, u0s=np.stack([u0, u0]))
    assert res.success and res.u.shape[0] == 2
    np.testing.assert_array_equal(res.u[0], res.u[1])
    assert np.max(np.abs(res.u[0] - ens.u[0])) <= 1e-12
    assert res.vcs == {}


def test_condition_sweep_tables_match_jax():
    from kinetica_tpu.parallel.batching import build_condition_sweep as ref
    from kinetica_tpu_torch.parallel.batching import build_condition_sweep
    sd, rd, calc, conds, pars, _ = _setup("kinetica_tpu")
    t0, k0 = ref(conds, calc, rd.nr, pars)
    sd, rd, calc, conds, pars, _ = _setup("kinetica_tpu_torch")
    t1, k1 = build_condition_sweep(conds, calc, rd.nr, pars)
    np.testing.assert_array_equal(t1, t0)
    assert k1.shape == (B, t0.size, rd.nr)
    np.testing.assert_allclose(k1, k0, rtol=1e-14, atol=0)


def test_gather_lanes_shares_the_stop_grid():
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    sd, rd, _, _, _, method = _setup("kinetica_tpu_torch")
    ep = EnsembleProblem(method, sd, rd, device="cpu")
    u0s = torch.arange(8.0, dtype=torch.float64).reshape(4, 2)
    tables = torch.arange(24.0, dtype=torch.float64).reshape(4, 3, 2)
    stops = torch.ones(4, 1, dtype=torch.float64)
    u0_r, (ts_r, kt_r), st_r = ep._gather_lanes(
        u0s, (torch.zeros(3), tables), stops, np.array([2, 0, 2]))
    assert torch.equal(u0_r, u0s[[2, 0, 2]]) and torch.equal(kt_r,
                                                             tables[[2, 0, 2]])
    assert st_r is stops and torch.equal(ts_r, torch.zeros(3))


GRID = np.array([0.0, 0.1, 0.2, 0.35, 1.0])


@pytest.mark.parametrize("tq", [-0.5, 0.0, 0.05, 0.1, 0.2 - 1e-16, 0.2, 0.3,
                                0.35, 0.999, 1.0, 7.0])
def test_left_constant_lookup_matches_jax(tq):
    from kinetica_tpu.ops.interp import left_constant_lookup as ref
    from kinetica_tpu_torch.ops.interp import left_constant_lookup
    table = np.random.default_rng(1).standard_normal((3, GRID.size, 4))
    q = np.array([tq, tq + 0.01, tq - 0.01])
    got = left_constant_lookup(torch.as_tensor(q), torch.as_tensor(GRID),
                               torch.as_tensor(table)).numpy()
    shared = left_constant_lookup(torch.as_tensor(q), torch.as_tensor(GRID),
                                  torch.as_tensor(table[0])).numpy()
    for b in range(3):
        want = np.asarray(ref(jnp.asarray(q[b]), jnp.asarray(GRID),
                              jnp.asarray(table[b])))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(
            shared[b], np.asarray(ref(jnp.asarray(q[b]), jnp.asarray(GRID),
                                      jnp.asarray(table[0]))))


def test_ensemble_defaults_match_the_reference():
    """The reference defaults to rate_mode="discrete" and chunk_mode="auto"
    (its production formalism); the port takes the same defaults."""
    from kinetica_tpu.parallel import batching as ref
    from kinetica_tpu_torch.parallel import batching as port
    for fn in ("__init__",):
        p0 = inspect.signature(getattr(ref.EnsembleProblem, fn)).parameters
        p1 = inspect.signature(getattr(port.EnsembleProblem, fn)).parameters
        for name in ("rate_mode", "chunk_mode"):
            assert p1[name].default == p0[name].default, name
    p0 = inspect.signature(ref.solve_network_ensemble).parameters
    p1 = inspect.signature(port.solve_network_ensemble).parameters
    assert p1["rate_mode"].default == p0["rate_mode"].default == "discrete"


def test_solve_network_ensemble_fused_solve_and_dd(solves):
    """The one-shot entry point with the configuration of the on-card run,
    inv_fused + dd: member 0 against the ensemble with the defaults."""
    from kinetica_tpu_torch.parallel.batching import solve_network_ensemble
    _, ens, _ = solves
    sd, rd, _, conds, _, method = _setup("kinetica_tpu_torch",
                                         linsolve="inv_fused",
                                         rhs_contraction="dd")
    res = solve_network_ensemble(method, sd, rd, conditions_list=conds[:1],
                                 device="cpu")
    assert res.success and res.u.shape == ens.u[:1].shape
    assert np.max(np.abs(res.u[0] - ens.u[0])) <= 1e-6


def test_auto_chunk_mode_resolves_to_async():
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    sd, rd, _, _, _, method = _setup("kinetica_tpu_torch")
    assert EnsembleProblem(method, sd, rd,
                           device="cpu").chunk_mode == "async"
    with pytest.raises(ValueError, match="not ported"):
        EnsembleProblem(method, sd, rd, chunk_mode="scan", device="cpu")
