"""The port's adjoint gradient against the JAX package's.

A 4-species static toy CRN (A <=> B, 2B -> C, C -> D; k = 1e3, 5e2, 3e2,
1 /s; tf = 2 s) with a terminal objective on C: the port's
``solve_adjoint_gradient`` (on the CPU: f32 Newton Jacobian, the
Gauss-Jordan kernel's plain version) with the reference's storage grid
(``n_store=n_nodes``) against the JAX package's (f64 J, LU) within 1e-4
of max|grad|, and with its own default (u interpolated from a grid 32x
finer) against the JAX package's forward sensitivities ``w @ S[-1]``
within 2% of max|grad| (two derivative methods, ~0.7% apart in the JAX
package itself). A least-squares objective goes through
``torch.autograd`` on the port's side and ``jax.grad`` on the
reference's. The reference's own adjoint
tests need a data file that is not in the repository.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RATES = np.array([1e3, 5e2, 3e2, 1.0])
TARGET = np.array([0.05, 0.3])          # a misfit on (B, C) at tf


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _toy(pkg, cls="StaticODESolve"):
    import importlib
    net_m = importlib.import_module(f"{pkg}.core.network")
    calc_m = importlib.import_module(f"{pkg}.calculators.builtin")
    cs_m = importlib.import_module(f"{pkg}.conditions.condition_set")
    prof_m = importlib.import_module(f"{pkg}.conditions.profiles")
    par_m = importlib.import_module(f"{pkg}.solving.params")
    meth_m = importlib.import_module(f"{pkg}.solving.methods")
    sd = net_m.SpeciesData(["A", "B", "C", "D"])
    rd = net_m.RxData.from_reactions(sd, [["A"], ["B"], ["B", "B"], ["C"]],
                                     [["B"], ["A"], ["C"], ["D"]])
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = calc_m.DummyKineticCalculator(RATES, **kw)
    pars = par_m.ODESimulationParams(tspan=(0.0, 2.0), u0={"A": 1.0},
                                     low_k_cutoff="none")
    if cls == "StaticODESolve":
        cs = cs_m.ConditionSet({"T": 300.0})
    else:
        cs = cs_m.ConditionSet({"T": prof_m.LinearGradientProfile(
            rate=10.0, X_start=300.0, X_end=320.0)})
    return getattr(meth_m, cls)(pars, cs, calc), sd, rd


def _one_hot_c(sd):
    w = np.zeros(sd.n)
    w[sd.toInt["C"]] = 1.0
    return w


@pytest.fixture(scope="module")
def reference():
    from kinetica_tpu.solving.adjoint import solve_adjoint_gradient
    from kinetica_tpu.solving.sensitivity import solve_network_sensitivities
    method, sd, rd = _toy("kinetica_tpu")
    w = _one_hot_c(sd)
    grad, g = solve_adjoint_gradient(method, sd, rd, w)
    sens = solve_network_sensitivities(method, sd, rd)
    idx = [sd.toInt["B"], sd.toInt["C"]]
    target = jnp.asarray(TARGET)

    def misfit(u):
        return jnp.sum((u[jnp.asarray(idx)] - target) ** 2)
    grad_o, g_o = solve_adjoint_gradient(method, sd, rd, objective=misfit)
    return dict(grad=grad, g=g, fwd=w @ np.asarray(sens.S)[-1],
                grad_o=grad_o, g_o=g_o, idx=idx)


@pytest.fixture(scope="module")
def port():
    from kinetica_tpu_torch.solving import adjoint
    method, sd, rd = _toy("kinetica_tpu_torch")
    grad, g = adjoint.solve_adjoint_gradient(method, sd, rd, _one_hot_c(sd),
                                             device="cpu", n_store=257)
    stats = dict(adjoint.last_stats)
    fine, _ = adjoint.solve_adjoint_gradient(method, sd, rd, _one_hot_c(sd),
                                             device="cpu")
    return dict(grad=grad, g=g, nr=rd.nr, stats=stats, fine=fine)


def test_weights_match_jax_adjoint(reference, port):
    grad, ref = port["grad"], reference["grad"]
    assert grad.shape == (port["nr"],)
    np.testing.assert_allclose(port["g"], reference["g"], rtol=1e-6)
    assert np.abs(grad - ref).max() <= 1e-4 * np.abs(ref).max()
    # the backward solve ran (its steps are kept for the caller)
    assert port["stats"]["backward"]["n_steps"] > 0
    assert port["stats"]["backward"]["n_lu"] > 0


def test_weights_match_jax_forward_sensitivities(reference, port):
    fwd = reference["fwd"]
    for grad in (port["grad"], port["fine"]):
        assert np.abs(grad - fwd).max() <= 0.02 * np.abs(fwd).max()


def test_objective_matches_jax(reference):
    from kinetica_tpu_torch.solving.adjoint import solve_adjoint_gradient
    method, sd, rd = _toy("kinetica_tpu_torch")
    idx = torch.as_tensor(reference["idx"])
    target = torch.as_tensor(TARGET)

    def misfit(u):
        return torch.sum((u[idx] - target) ** 2)
    grad, g = solve_adjoint_gradient(method, sd, rd, objective=misfit,
                                     device="cpu", n_store=257)
    ref = reference["grad_o"]
    np.testing.assert_allclose(g, reference["g_o"], rtol=1e-6)
    assert np.abs(grad - ref).max() <= 1e-4 * np.abs(ref).max()


def test_guards():
    from kinetica_tpu_torch.solving.adjoint import solve_adjoint_gradient
    method, sd, rd = _toy("kinetica_tpu_torch", cls="VariableODESolve")
    with pytest.raises(TypeError, match="StaticODESolve"):
        solve_adjoint_gradient(method, sd, rd, _one_hot_c(sd), device="cpu")
    method, sd, rd = _toy("kinetica_tpu_torch")
    with pytest.raises(ValueError, match="exactly one"):
        solve_adjoint_gradient(method, sd, rd, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        solve_adjoint_gradient(method, sd, rd, _one_hot_c(sd),
                               objective=lambda u: u.sum(), device="cpu")
    with pytest.raises(ValueError, match="n_nodes"):
        solve_adjoint_gradient(method, sd, rd, _one_hot_c(sd), n_nodes=32,
                               device="cpu")
    with pytest.raises(ValueError, match="shape"):
        solve_adjoint_gradient(method, sd, rd, np.ones(3), device="cpu")
