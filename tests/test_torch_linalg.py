"""The port's Newton linear algebra against ``kinetica_tpu.ops.linalg``.

The JAX side runs its accelerator algorithm on the CPU: ``inv_gated``
(the Pallas Gauss-Jordan kernel in interpret mode), two unrolled
refinement sweeps (``KINETICA_REFINE=unroll:2``) and the f64-dot
Newton-Schulz residual (``KINETICA_NS_RESIDUAL=f64dot``), both set through
``monkeypatch``. Tolerances: solutions 1e-9 relative for an f64 Jacobian
(both refine against f64 residuals); factors 3e-4 relative, the
Newton-Schulz tolerance (both are f32 inverses, refined to that level).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def accelerator_algorithm(monkeypatch):
    monkeypatch.setenv("KINETICA_REFINE", "unroll:2")
    monkeypatch.setenv("KINETICA_NS_RESIDUAL", "f64dot")


def _case(B, n, seed, jdt=np.float64):
    """Newton systems from the nc=6 mass-action Jacobian at random states."""
    from kinetica_tpu.calculators.builtin import PrecalculatedArrheniusCalculator
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(6)
    net = build_mass_action(rd, sd.n)
    rng = np.random.default_rng(seed)
    u = 10.0 ** rng.uniform(-10, -1, (B, sd.n))
    k = np.asarray(PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)(
        jnp.asarray(rng.uniform(700, 1300, B))))
    J = np.asarray(jax.vmap(net.jac)(jnp.asarray(u), jnp.asarray(k))).astype(jdt)
    c = 10.0 ** rng.uniform(-10, -8, B)
    b = rng.standard_normal((B, sd.n))
    return J, c, b


def _jax_factor_solve(J, c, b, need=None):
    from kinetica_tpu.ops.linalg import NewtonFactors, newton_factor, newton_solve

    def one(J1, c1, b1, n1):
        f = newton_factor(J1, c1, jnp.float32, method="inv_gated", need=n1)
        f = NewtonFactors(lu=f.lu, piv=f.piv, J=J1, c=c1)
        return f.lu, newton_solve(f, b1, method="inv_gated")

    need = np.ones(len(c), bool) if need is None else need
    M, dy = jax.vmap(one)(jnp.asarray(J), jnp.asarray(c), jnp.asarray(b),
                          jnp.asarray(need))
    return np.asarray(M), np.asarray(dy)


def _port_factor(J, c, need=None, prev=None):
    from kinetica_tpu_torch.ops.linalg import newton_factor
    return newton_factor(torch.as_tensor(J), torch.as_tensor(c),
                         method="inv_gated",
                         need=None if need is None else torch.as_tensor(need),
                         prev=prev)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("B,jdt,sol_tol", [(4, np.float64, 1e-9),
                                           (20, np.float64, 1e-9),
                                           (20, np.float32, 1e-5)])
def test_factor_and_solve_match(B, jdt, sol_tol):
    """With an f64 J both refinements converge to the f64 solution (1e-9).
    With the main path's f32 J they converge to the solution of the
    f32-rounded residual J dy, which moves with the summation order of
    that product: 1e-5."""
    from kinetica_tpu_torch.ops.linalg import newton_solve
    J, c, b = _case(B, 19, seed=B, jdt=jdt)
    M_ref, dy_ref = _jax_factor_solve(J, c, b)
    f = _port_factor(J, c)
    assert f.lu.dtype == torch.float32
    for i in range(B):
        assert _rel(f.lu[i].numpy(), M_ref[i]) <= 3e-4
    dy = newton_solve(f, torch.as_tensor(b)).numpy()
    for i in range(B):
        assert _rel(dy[i], dy_ref[i]) <= sol_tol


def test_solution_solves_the_f64_system():
    from kinetica_tpu_torch.ops.linalg import newton_solve
    J, c, b = _case(6, 19, seed=3, jdt=np.float64)
    dy = newton_solve(_port_factor(J, c), torch.as_tensor(b)).numpy()
    A = np.eye(19) - c[:, None, None] * J
    exact = np.linalg.solve(A, b[..., None])[..., 0]
    for i in range(6):
        assert _rel(dy[i], exact[i]) <= 1e-9


def test_gated_lanes_keep_their_old_factor():
    from kinetica_tpu_torch.ops.linalg import NewtonFactors
    B = 16
    J, c, b = _case(B, 19, seed=5)
    need = np.zeros(B, bool)
    need[[0, 5, 13]] = True
    old = torch.full((B, 19, 19), 7.0)
    prev = NewtonFactors(lu=old, piv=torch.zeros(B, 0, dtype=torch.int32),
                         J=torch.as_tensor(J), c=torch.as_tensor(c))
    f = _port_factor(J, c, need=need, prev=prev)
    M_ref, _ = _jax_factor_solve(J, c, b, need=need)
    for i in range(B):
        if need[i]:
            assert _rel(f.lu[i].numpy(), M_ref[i]) <= 3e-4
        else:
            assert torch.equal(f.lu[i], old[i])


def test_newton_schulz_refines_a_rough_inverse():
    from kinetica_tpu.ops.dd import newton_schulz_refine as ref
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse
    from kinetica_tpu_torch.ops.linalg import _equilibrate, newton_schulz_refine
    # condition ~1e6 (max|A^-1| far above the proxy gate), so that the
    # f32 inverse is rough and both phases of the refinement run
    rng = np.random.default_rng(8)
    n = 19
    U, _ = np.linalg.qr(rng.standard_normal((4, n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((4, n, n)))
    s = np.logspace(0, -6, n)
    A = (U * s[None, None, :]) @ V.transpose(0, 2, 1)
    As, _, _ = _equilibrate(torch.as_tensor(A))
    M0 = gj_inverse(As.contiguous())
    M, rn = newton_schulz_refine(M0, As)
    assert float(1.2e-7 * M0.abs().amax()) > 1e-3     # the gate opens

    def resid(Mi, i):
        return np.abs(np.eye(n) - As[i].double().numpy()
                      @ np.asarray(Mi, np.float64)).max()

    for i in range(4):
        Mr, rnr = ref(jnp.asarray(M0[i].numpy()), jnp.asarray(As[i].numpy()))
        assert _rel(M[i].numpy(), np.asarray(Mr)) <= 3e-4
        # refinement improved the factor, as far as the reference did
        assert resid(M[i].numpy(), i) < resid(M0[i].numpy(), i)
        assert resid(M[i].numpy(), i) <= 2 * resid(np.asarray(Mr), i)
        np.testing.assert_allclose(float(rn[i]), float(rnr), rtol=0.1,
                                   atol=1e-6)


def test_lu_option_is_exact_f64():
    from kinetica_tpu_torch.ops.linalg import newton_factor, newton_solve
    J, c, b = _case(3, 19, seed=9, jdt=np.float64)
    f = newton_factor(torch.as_tensor(J), torch.as_tensor(c), method="lu")
    dy = newton_solve(f, torch.as_tensor(b), method="lu").numpy()
    exact = np.linalg.solve(np.eye(19) - c[:, None, None] * J, b[..., None])[..., 0]
    np.testing.assert_allclose(dy, exact, rtol=1e-10, atol=1e-14)
