"""Forward sensitivities on the static case of ``tests/test_sensitivity.py``
(900 K, 2 s in 8 chunks), rid validation and the continuous-rate refusal.

Bounds, against max|S| of each column: the port (its "inv_gated") against
the JAX package 2e-2 and against central differences of its own solve
5e-3 plus the difference quotient's noise (see
``test_torch_sensitivity.py``; measured here: S against the JAX package
9.0e-10, against the differences 6.3e-4 at most, noise below 1e-4).
"""
import numpy as np
import pytest
import torch

from test_torch_sensitivity import (RIDS, fd_errors, jax_sensitivities,
                                    make_problem, port_problem)

torch.set_num_threads(1)


def test_static_matches_jax_and_differences():
    static_ref = jax_sensitivities(variable=False)
    prob = port_problem(variable=False)
    sens = prob.solve()
    rel = np.abs(sens.S - static_ref.S).max() / np.abs(static_ref.S).max()
    print(f"port S vs the JAX package's: {rel:.2e} of max|S|")
    assert rel <= 2e-2
    for col, (err, noise) in enumerate(fd_errors(prob, sens.S)):
        print(f"rid {RIDS[col]}: vs central differences {err:.2e}, "
              f"noise {noise:.2e}")
        assert err < 5e-3 + noise, (RIDS[col], err, noise)


def test_rid_validation():
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    sd, rd, method = make_problem("kinetica_tpu_torch")
    with pytest.raises(ValueError, match="rids"):
        SensitivityProblem(method, sd, rd, rids=[rd.nr + 5], device="cpu")


def test_continuous_conditions_raise():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(4)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")
    cs = ConditionSet({"T": LinearGradientProfile(rate=100.0, X_start=700.0,
                                                  X_end=800.0)})
    pars = ODESimulationParams(tspan=(0.0, 1.0), u0={"C4": 1.0})
    with pytest.raises(ValueError, match="discrete-rate"):
        SensitivityProblem(VariableODESolve(pars, cs, calc), sd, rd,
                           device="cpu")
