"""The port's RK45 solver against the JAX package's.

``kinetica_tpu_torch.ops.rk45.rk45_solve`` takes the reference's steps
exactly (same tableau, controller and dense output), so on the cases of
``tests/test_rk45_analysis.py::TestRK45`` it agrees with the JAX
``rk45_solve`` to rounding: 1e-10 relative, the same step counts. A batch
of lanes with different initial states gives each lane's solo result.
``solve_network(..., solver="rk45")`` on the 3-species chain agrees with
the JAX package to 1e-10 and with the port's BDF solve to 1e-7 (the
reference test's bound).
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def test_exponential_decay_matches_jax():
    from kinetica_tpu.ops.rk45 import rk45_solve as jrk
    from kinetica_tpu_torch.ops.rk45 import DONE, rk45_solve
    sv = np.linspace(0.1, 2.0, 20)
    r0 = jrk(lambda t, y: -y, jnp.array([1.0]), 0.0, 2.0, jnp.asarray(sv),
             rtol=1e-9, atol=1e-12)
    r1 = rk45_solve(lambda t, y: -y, torch.tensor([[1.0]], dtype=torch.float64),
                    0.0, 2.0, sv, rtol=1e-9, atol=1e-12)
    assert int(r1.status[0]) == DONE
    assert int(r1.n_steps[0]) == int(r0.n_steps)
    np.testing.assert_allclose(r1.ys[0].numpy(), np.asarray(r0.ys),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(r1.ys[0, :, 0].numpy(), np.exp(-sv), rtol=1e-7)


def _vdp_jax(t, y):
    return jnp.array([y[1], (1 - y[0] ** 2) * y[1] - y[0]])


def _vdp_torch(t, y):
    return torch.stack([y[:, 1], (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]], 1)


def test_van_der_pol_batch_matches_jax_and_scipy():
    """Four lanes from different initial states: each equals the JAX solve
    of that lane (steps and values) and scipy's RK45 at the reference
    test's tolerances."""
    from scipy.integrate import solve_ivp
    from kinetica_tpu.ops.rk45 import rk45_solve as jrk
    from kinetica_tpu_torch.ops import host_sync
    from kinetica_tpu_torch.ops.rk45 import DONE, rk45_solve
    rng = np.random.default_rng(6)
    y0s = np.vstack([[2.0, 0.0], rng.uniform(-2.0, 2.0, (3, 2))])
    sv = np.linspace(0.5, 10.0, 20)
    host_sync.count = 0
    r1 = rk45_solve(_vdp_torch, torch.as_tensor(y0s), 0.0, 10.0, sv,
                    rtol=1e-9, atol=1e-12)
    # one counted read a step: the longest lane's steps, plus the exit
    assert host_sync.count == int(r1.n_steps.max()) + 1
    for b in range(len(y0s)):
        r0 = jrk(_vdp_jax, jnp.asarray(y0s[b]), 0.0, 10.0, jnp.asarray(sv),
                 rtol=1e-9, atol=1e-12)
        assert int(r1.status[b]) == DONE
        assert int(r1.n_steps[b]) == int(r0.n_steps)
        np.testing.assert_allclose(r1.ys[b].numpy(), np.asarray(r0.ys),
                                   rtol=1e-10, atol=1e-12)
        sp = solve_ivp(lambda t, y: np.array([y[1], (1 - y[0] ** 2) * y[1]
                                              - y[0]]),
                       (0, 10), y0s[b], rtol=1e-11, atol=1e-13, t_eval=sv,
                       method="RK45")
        np.testing.assert_allclose(r1.ys[b].numpy(), sp.y.T, rtol=1e-5,
                                   atol=1e-7)


def test_stops_are_not_straddled():
    """A stop inside the window is landed on exactly (the JAX solve takes
    the same steps)."""
    from kinetica_tpu.ops.rk45 import rk45_solve as jrk
    from kinetica_tpu_torch.ops.rk45 import rk45_solve
    sv = np.array([0.5, 1.0, 1.5])
    stops = np.array([0.7, np.inf])
    r0 = jrk(lambda t, y: -2.0 * y, jnp.array([1.0, 3.0]), 0.0, 1.5,
             jnp.asarray(sv), rtol=1e-8, atol=1e-12, stops=jnp.asarray(stops))
    r1 = rk45_solve(lambda t, y: -2.0 * y,
                    torch.tensor([[1.0, 3.0]], dtype=torch.float64), 0.0, 1.5,
                    sv, rtol=1e-8, atol=1e-12, stops=stops)
    assert int(r1.n_steps[0]) == int(r0.n_steps)
    np.testing.assert_allclose(r1.ys[0].numpy(), np.asarray(r0.ys),
                               rtol=1e-10, atol=0)


def _chain(pkg, solver):
    import importlib
    net_m = importlib.import_module(f"{pkg}.core.network")
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    meth_m = importlib.import_module(f"{pkg}.solving.methods")
    sd = net_m.SpeciesData(["A", "B", "C"])
    rd = net_m.RxData.from_reactions(sd, [["A"], ["B"], ["B", "B"]],
                                     [["B"], ["A"], ["C"]])
    pars = par_m.ODESimulationParams(
        tspan=(0.0, 10.0), u0={"A": 1.0}, solver=solver, solve_chunks=True,
        solve_chunkstep=1.0, reltol=1e-9, abstol=1e-12, low_k_cutoff="none")
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = calc_m.DummyKineticCalculator(np.array([1.0, 0.5, 0.3]), **kw)
    method = meth_m.StaticODESolve(pars, cs_m.ConditionSet({"T": 300.0}), calc)
    return meth_m.solve_network(method, sd, rd, **kw)


def test_solve_network_rk45_chain():
    ref = _chain("kinetica_tpu", "rk45")
    out = _chain("kinetica_tpu_torch", "rk45")
    bdf = _chain("kinetica_tpu_torch", "bdf")
    for res in (out, bdf):
        assert res.sol.success, res.sol.retcode
        assert res.sol.u.shape == ref.sol.u.shape
    assert np.max(np.abs(out.sol.u - ref.sol.u)) <= 1e-10
    assert np.max(np.abs(out.sol.u - bdf.sol.u)) <= 1e-7
    assert out.sol.stats["n_steps"] == ref.sol.stats["n_steps"]
    assert out.sol.stats["n_jev"] == out.sol.stats["n_lu"] == 0
