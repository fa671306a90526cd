"""The forward tangent's Newton iteration converges on its own
(``ops/bdf.py``, ``newton_iterate``), on the ramp of ``chip_smoke.py``
phase 14b: ``synthetic_pyrolysis_network(24)``, 700 -> 1100 K at 100 K/s,
rates updated every 0.5 s, 4 s in 8 chunks, rtol 1e-8 / atol 1e-10, the
two columns that phase holds (reactions 534 and 552, its largest).

The Newton factor's inverse is eliminated in f64, and the primal's
Newton iteration then often stops after its first or second update.
Stopped by the primal's test alone, reaction 534's tangent lay 85% of
max|S| off its central differences here (3.2e-2 and 1.5e-2 for both
columns with reaction 0's lane beside them; 2.3e-2 and 1.1e-2 in phase
14b on an H100, which holds 5e-3 plus the quotient's noise). Iterated on
until its own update passes the same test, it lies 1.0e-6 and 5.0e-6 off;
it is held here at 5e-4 plus the noise (the second difference of the
three lanes over 2 eps), a tenth of the card's bound. The iterations
after the primal's last move the tangent only: lane 0's primal is the
plain solve's, bit for bit.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NC = 24
RIDS = [534, 552]
EPS = 1e-4


@pytest.fixture(scope="module")
def ramp():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

    sd, rd, Ea, A = synthetic_pyrolysis_network(NC)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")
    cs = ConditionSet({"T": LinearGradientProfile(
        rate=100.0, X_start=700.0, X_end=1100.0)}, ts_update=0.5)
    tf = cs.get_t_final()
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=tf / 8, low_k_cutoff="none", abstol=1e-10,
        reltol=1e-8)
    prob = SensitivityProblem(VariableODESolve(pars, cs, calc), sd, rd,
                              rids=RIDS, device="cpu")
    return prob, prob.solve()


def test_primal_is_the_plain_solve(ramp):
    # the plain solve of theta = 0 over as many lanes (the CPU's batched
    # kernels round by the batch's shape)
    prob, sens = ramp
    ys, _ = prob._solve_theta(np.zeros((len(RIDS), len(RIDS))))
    np.testing.assert_array_equal(ys[0].numpy(), sens.u[1:])


def test_tangent_matches_central_differences(ramp):
    prob, sens = ramp
    P = len(RIDS)
    theta = np.zeros((2 * P + 1, P))
    for col in range(P):
        theta[2 * col, col], theta[2 * col + 1, col] = EPS, -EPS
    ys, status = prob._solve_theta(theta)
    assert np.all(status.numpy() == 1)
    ys = ys.numpy()
    for col, rid in enumerate(RIDS):
        up, down, mid = ys[2 * col], ys[2 * col + 1], ys[2 * P]
        scale = np.abs(sens.S[1:, :, col]).max()
        err = np.abs(sens.S[1:, :, col] - (up - down) / (2 * EPS)).max() / scale
        noise = np.abs(up + down - 2 * mid).max() / (2 * EPS) / scale
        print(f"rid {rid}: vs central differences {err:.2e} of max|S| "
              f"{scale:.3e}, noise {noise:.2e}")
        assert err <= 5e-4 + noise, (rid, err, noise)
