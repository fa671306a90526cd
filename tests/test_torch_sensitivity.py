"""Forward sensitivities (``solving/sensitivity.py``) of the port against
the JAX package and against central differences of the port's own
solve, on the cases of ``tests/test_sensitivity.py``
(``synthetic_pyrolysis_network(6)``, rids [0, 3, 7]).

The port resolves ``linsolve="auto"`` to "inv_gated" on the CPU too (an
f32 Gauss-Jordan factor with rule 2 as its tangent); the JAX package's
CPU run is "lu". Bounds, each against max|S| of its column:

* port S against the JAX package's: 2e-2, the reference's own inv-vs-lu
  bound, against max|S| over all columns (measured: 1.0e-8 on the ramp)
  and against each column's own (measured: 1.3e-3 on reaction 0's column,
  max|S| 2.7e-6; 2e-9 and 4e-9 on the others);
* port S against central differences (eps 1e-4 in theta, the reference
  test's) of the port's ``_solve_theta``, one batched call with the +-eps
  lanes and a centre lane: 5e-3, the reference test's bound, plus the
  difference quotient's noise (the second difference of the three lanes
  over 2 eps). The f32 factor rounds differently at theta +- eps, so the
  primal's noise is ~1e-11 where the f64 LU's is ~1e-14: on the ramp,
  reaction 0's column (max|S| 2.7e-6) differs from its quotient by 3.2%
  while that noise term is 11%; the other columns agree within 1.7e-4.
  Under "lu" the noise term stays below 1e-3 and the bound is the
  reference's (``test_torch_sensitivity_lu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RIDS = [0, 3, 7]
EPS = 1e-4


def make_problem(pkg, variable=True, nc=6):
    """``tests/test_sensitivity.py::make_problem`` for either package."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    sd, rd, Ea, A = mod("testing.synthetic").synthetic_pyrolysis_network(nc)
    calc = mod("calculators.builtin").PrecalculatedArrheniusCalculator(
        Ea, A, k_max=1e12, **kw)
    ConditionSet = mod("conditions.condition_set").ConditionSet
    methods = mod("solving.methods")
    params = mod("solving.params")
    if variable:
        conditions = ConditionSet(
            {"T": mod("conditions.profiles").LinearGradientProfile(
                rate=100.0, X_start=700.0, X_end=1100.0)}, ts_update=0.5)
        tf = conditions.get_t_final()
        pars = params.ODESimulationParams(
            tspan=(0.0, tf), u0={f"C{nc}": 1.0}, solve_chunks=True,
            solve_chunkstep=tf / 8, low_k_cutoff="none")
        method = methods.VariableODESolve(pars, conditions, calc)
    else:
        conditions = ConditionSet({"T": 900.0})
        pars = params.ODESimulationParams(
            tspan=(0.0, 2.0), u0={f"C{nc}": 1.0}, solve_chunks=True,
            solve_chunkstep=0.25, low_k_cutoff="none")
        method = methods.StaticODESolve(pars, conditions, calc)
    return sd, rd, method


def jax_sensitivities(variable, rids=RIDS):
    from kinetica_tpu.solving.sensitivity import SensitivityProblem
    sd, rd, method = make_problem("kinetica_tpu", variable)
    return SensitivityProblem(method, sd, rd, rids=rids).solve()


def port_problem(variable, rids=RIDS):
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    sd, rd, method = make_problem("kinetica_tpu_torch", variable)
    return SensitivityProblem(method, sd, rd, rids=rids, device="cpu")


def fd_errors(prob, S, eps=EPS):
    """Per column: (|S - central difference| / max|S|, noise / max|S|),
    the differences from one batched ``_solve_theta`` call."""
    P = S.shape[2]
    theta = np.zeros((2 * P + 1, P))
    for col in range(P):
        theta[2 * col, col], theta[2 * col + 1, col] = eps, -eps
    ys, status = prob._solve_theta(theta)
    assert np.all(status.numpy() == 1)
    ys = ys.numpy()
    out = []
    for col in range(P):
        up, down, mid = ys[2 * col], ys[2 * col + 1], ys[2 * P]
        scale = np.abs(S[1:, :, col]).max() + 1e-12
        err = np.abs(S[1:, :, col] - (up - down) / (2 * eps)).max() / scale
        noise = np.abs(up + down - 2 * mid).max() / (2 * eps) / scale
        out.append((err, noise))
    return out


@pytest.fixture(scope="module")
def ramp():
    prob = port_problem(variable=True)
    return prob, prob.solve()


def test_shapes_and_lanes(ramp):
    prob, sens = ramp
    assert sens.u.shape[0] == sens.t.shape[0]
    assert sens.S.shape == sens.u.shape + (len(RIDS),)
    assert np.all(sens.S[0] == 0.0)
    assert sens.stats["lanes"] == len(RIDS)
    # lane 0's primal is the plain solve of theta = 0
    ys, _ = prob._solve_theta(np.zeros(len(RIDS)))
    np.testing.assert_array_equal(ys[0].numpy(), sens.u[1:])


@pytest.fixture(scope="module")
def jax_ramp():
    return jax_sensitivities(variable=True)


def test_matches_jax_package(ramp, jax_ramp):
    _, sens = ramp
    ref = jax_ramp
    np.testing.assert_allclose(sens.t, ref.t)
    scale = np.abs(ref.S).max()
    rel = np.abs(sens.S - ref.S).max() / scale
    print(f"port S vs the JAX package's: {rel:.2e} of max|S|")
    assert rel <= 2e-2
    assert np.abs(sens.u - ref.u).max() <= 1e-8


def test_matches_jax_package_per_column(ramp, jax_ramp):
    """Each column against its own max|S|, so that a column far smaller
    than the others (reaction 0's) is held too."""
    _, sens = ramp
    for col, rid in enumerate(RIDS):
        scale = np.abs(jax_ramp.S[:, :, col]).max()
        assert scale > 0
        rel = np.abs(sens.S[:, :, col] - jax_ramp.S[:, :, col]).max() / scale
        print(f"rid {rid}: port S vs the JAX package's {rel:.2e} of the "
              f"column's max|S| {scale:.2e}")
        assert rel <= 2e-2, (rid, rel)


def test_matches_finite_differences(ramp):
    prob, sens = ramp
    for col, (err, noise) in enumerate(fd_errors(prob, sens.S)):
        print(f"rid {RIDS[col]}: vs central differences {err:.2e}, "
              f"noise {noise:.2e}")
        assert err < 5e-3 + noise, (RIDS[col], err, noise)
