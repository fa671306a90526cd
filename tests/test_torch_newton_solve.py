"""Kernel 4 (fused Newton solve): its plain version against the reference.

The reference is ``kinetica_tpu.ops.pallas_linalg.fused_newton_solve``
with ``interpret=True`` (the Pallas kernel run by the interpreter on the
CPU), under ``jax.vmap``, fed the same numpy-seeded M, J, b and c. The
systems are those of ``tests/test_pallas_linalg.py::TestFusedNewtonSolve``:
random J (optionally with rows scaled over 6 decades), c = 0.05, and M the
f32 inverse of I - c J32, or of I - 1.2 c J for a stale c.

Tolerances, relative to each lane's max |dy|: 3e-6 port vs reference and
either vs the dense f64 solve of (I - c J32) (the refinement's J matvec
rounds at f32, ~c eps32 |J| |dy|); 2e-4 with the stale-c preconditioner,
as the reference's own test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _mk(n=12, B=5, c0=0.05, seed=3, cond_spike=False, stale=1.0):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, n, n))
    if cond_spike:
        J = J * 10.0 ** rng.uniform(-3, 3, (B, n, 1))
    c = np.full(B, c0)
    b = rng.standard_normal((B, n))
    J32 = J.astype(np.float32)
    A = np.eye(n)[None] - c[:, None, None] * J32.astype(np.float64)
    M = np.linalg.inv(np.eye(n)[None] - stale * c[:, None, None] * J).astype(
        np.float32)
    return M, J32, b, c, A


def _jax_solve(M, J, b, c, n_sweeps=4):
    from kinetica_tpu.ops.pallas_linalg import fused_newton_solve
    return np.asarray(jax.vmap(lambda *t: fused_newton_solve(
        *t, n_sweeps=n_sweeps, interpret=True))(
            jnp.asarray(M), jnp.asarray(J), jnp.asarray(b), jnp.asarray(c)))


def _port_solve(M, J, b, c, n_sweeps=4):
    from kinetica_tpu_torch.ops.newton_solve import fused_newton_solve
    return fused_newton_solve(torch.as_tensor(M), torch.as_tensor(J),
                              torch.as_tensor(b), torch.as_tensor(c),
                              n_sweeps=n_sweeps).numpy()


def _lane_err(x, ref):
    return np.abs(x - ref).max(axis=1) / np.abs(ref).max(axis=1)


@pytest.mark.parametrize("n,B,spike,seed", [(12, 5, False, 3), (6, 8, False, 9),
                                            (12, 4, True, 4), (181, 3, False, 5),
                                            (181, 2, True, 8), (512, 2, False, 6)])
def test_plain_matches_pallas_interpret(n, B, spike, seed):
    """Up to the kernel's widest system, n = 512 (the multi-tile widths
    raised before the kernel took n > 128); c shrinks as 1 / sqrt(n) from
    n = 12 on, so c J keeps the spectral radius of the n = 12 systems."""
    c0 = 0.05 * min(1.0, np.sqrt(12 / n))
    M, J, b, c, A = _mk(n=n, B=B, c0=c0, seed=seed, cond_spike=spike)
    dy = _port_solve(M, J, b, c)
    dy_ref = _jax_solve(M, J, b, c)
    assert np.all(_lane_err(dy, dy_ref) <= 3e-6)
    exact = np.linalg.solve(A, b[..., None])[..., 0]
    assert np.all(_lane_err(dy, exact) <= 3e-6)
    assert np.all(_lane_err(dy_ref, exact) <= 3e-6)


def test_stale_c_preconditioner_refines():
    """M built at a 20%-drifted c: the sweeps recover the solution of the
    CURRENT (I - c J), as the reference's own stale-c test requires."""
    M, J, b, c, A = _mk(stale=1.2)
    dy = _port_solve(M, J, b, c)
    exact = np.linalg.solve(A, b[..., None])[..., 0]
    assert np.all(_lane_err(dy, exact) <= 2e-4)
    assert np.all(_lane_err(dy, _jax_solve(M, J, b, c)) <= 2e-4)


def test_converged_lane_is_frozen():
    """Lane 0's exact preconditioner converges in the mandatory sweep, so
    extra sweeps leave it bit for bit as one sweep left it; lane 1's stale
    preconditioner keeps refining."""
    M, J, b, c, _ = _mk(n=8, B=2, seed=5)
    M_stale, *_ = _mk(n=8, B=2, seed=5, stale=1.5)
    M[1] = M_stale[1]
    one = _port_solve(M, J, b, c, n_sweeps=1)
    four = _port_solve(M, J, b, c, n_sweeps=4)
    np.testing.assert_array_equal(four[0], one[0])
    assert np.abs(four[1] - one[1]).max() > 0.0


def test_one_sweep_matches_reference():
    M, J, b, c, _ = _mk(n=10, B=3, seed=11, stale=1.2)
    dy = _port_solve(M, J, b, c, n_sweeps=1)
    assert np.all(_lane_err(dy, _jax_solve(M, J, b, c, n_sweeps=1)) <= 3e-6)


def test_linalg_inv_fused_matches_inv_gated():
    """Through ``ops.linalg`` on Newton systems of the nc=6 mass-action
    Jacobian (f32, as on the main path): the three inverse methods build
    the same factor, and the fused solve agrees with the two-sweep solve
    to the f32-J floor (1e-5, as tests/test_torch_linalg.py)."""
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.models.mass_action import build_mass_action
    from kinetica_tpu_torch.ops.linalg import newton_factor, newton_solve
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    net = build_mass_action(rd, sd.n, device="cpu").to_dtype(torch.float32)
    rng = np.random.default_rng(7)
    B = 6
    u = torch.as_tensor(10.0 ** rng.uniform(-10, -1, (B, sd.n)))
    k = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")(
        torch.as_tensor(rng.uniform(700, 1300, B)))
    J = net.jac_matmul(u.float(), k.float())
    c = torch.as_tensor(10.0 ** rng.uniform(-10, -8, B))
    b = torch.as_tensor(rng.standard_normal((B, sd.n)))
    f = {m: newton_factor(J, c, method=m) for m in ("inv", "inv_gated",
                                                     "inv_fused")}
    assert torch.equal(f["inv"].lu, f["inv_gated"].lu)
    assert torch.equal(f["inv_fused"].lu, f["inv_gated"].lu)
    dy_f = newton_solve(f["inv_fused"], b, method="inv_fused").numpy()
    dy_g = newton_solve(f["inv_gated"], b, method="inv_gated").numpy()
    np.testing.assert_array_equal(
        newton_solve(f["inv"], b, method="inv").numpy(), dy_g)
    assert np.all(_lane_err(dy_f, dy_g) <= 1e-5)


@pytest.mark.parametrize("what", ["M_f64", "b_f32", "c_shape", "J_shape",
                                  "wide", "sweeps", "noncontig"])
def test_guard_rejects_bad_inputs(what):
    from kinetica_tpu_torch.ops.newton_solve import fused_newton_solve
    M, J, b, c, _ = _mk(n=6, B=3)
    M, J, b, c = map(torch.as_tensor, (M, J, b, c))
    args = {
        "M_f64": (M.double(), J, b, c),
        "b_f32": (M, J, b.float(), c),
        "c_shape": (M, J, b, c[:2]),
        "J_shape": (M, J[:, :5, :5].contiguous(), b, c),
        "wide": (torch.zeros(1, 513, 513), torch.zeros(1, 513, 513),
                 torch.zeros(1, 513, dtype=torch.float64),
                 torch.zeros(1, dtype=torch.float64)),
        "sweeps": (M, J, b, c),
        "noncontig": (M.transpose(1, 2), J, b, c),
    }[what]
    with pytest.raises((TypeError, ValueError)):
        fused_newton_solve(*args, n_sweeps=0 if what == "sweeps" else 4)


def test_cpu_call_launches_nothing():
    from kinetica_tpu_torch.ops import grid_probe, newton_solve
    newton_solve.launches = grid_probe.launches = 0
    M, J, b, c, _ = _mk(n=6, B=2)
    _port_solve(M, J, b, c)
    assert newton_solve.launches == 0 and grid_probe.launches == 0
