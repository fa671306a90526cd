"""The forward sensitivity of a reaction saturated from the start, in the
JAX package: reaction 0 of ``synthetic_pyrolysis_network(24)`` (C2 -> 2
CH3, at k_max from t = 0) on the ramp of ``tests/test_sensitivity.py``
(700 -> 1100 K at 100 K/s, rates every 0.5 s, 1e-8 / 1e-10).

The reference's own S for that reaction is ~100% off central differences
(eps 1e-4) of its own solve (measured 1.0 of max|S|; reaction 552, which
the port holds within 2.0e-3 on the card, is 0.49 off here, printed by
this test). The port's S for reaction 0 is off alike
(``chip_smoke.py`` phase 14b; ``python -m kinetica_tpu_torch.scripts.
sensitivity_checks trace`` shows the perturbed lanes bit-identical while
the tangent grows). This is why phase 14b reports reaction 0's column
instead of holding it.
"""
import jax.numpy as jnp
import numpy as np


def test_reference_tangent_of_saturated_channel_misses_its_differences():
    from kinetica_tpu.calculators.builtin import \
        PrecalculatedArrheniusCalculator
    from kinetica_tpu.conditions.condition_set import ConditionSet
    from kinetica_tpu.conditions.profiles import LinearGradientProfile
    from kinetica_tpu.solving.methods import VariableODESolve
    from kinetica_tpu.solving.params import ODESimulationParams
    from kinetica_tpu.solving.sensitivity import SensitivityProblem
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(24)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)
    cs = ConditionSet({"T": LinearGradientProfile(
        rate=100.0, X_start=700.0, X_end=1100.0)}, ts_update=0.5)
    tf = cs.get_t_final()
    pars = ODESimulationParams(tspan=(0.0, tf), u0={"C24": 1.0},
                               solve_chunks=True, solve_chunkstep=tf / 8,
                               low_k_cutoff="none", abstol=1e-10, reltol=1e-8)
    prob = SensitivityProblem(VariableODESolve(pars, cs, calc), sd, rd,
                              rids=[0, 552])
    S = np.asarray(prob.solve().S)
    eps, err = 1e-4, []
    for col in range(2):
        us = []
        for sign in (1.0, -1.0):
            theta = np.zeros(2)
            theta[col] = sign * eps
            ys, status = prob._solve_theta(jnp.asarray(theta), prob._ktab,
                                           prob._u0)
            assert int(status) == 1
            us.append(np.asarray(ys))
        fd = (us[0] - us[1]) / (2 * eps)
        scale = np.abs(S[1:, :, col]).max()
        err.append(np.abs(S[1:, :, col] - fd).max() / scale)
    print(f"reference S vs central differences, rids 0 and 552: {err}")
    assert err[0] > 0.5, err
