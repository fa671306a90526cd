"""The block-Schur inverse (n = 129-512) against the JAX package.

``schur_inverse`` composes Gauss-Jordan inverses of diagonal blocks of at
most 128 rows with f32 coupling products, split as the reference's
``kinetica_tpu.ops.pallas_linalg.schur_inverse`` splits (181 -> 128 + 53,
300 -> 128 + (128 + 44)). The JAX side runs its Pallas kernel with
``interpret=True``; on the CPU the port runs the same composition over the
kernel's plain version. Tolerances: 1e-5 in relative Frobenius norm per
member (both are f32 with the same elimination order), on well-conditioned
matrices, where rounding is not amplified; the stiff matrix of
``tests/test_pallas_linalg.py::TestSchurInverse`` must come back inside
Newton-Schulz's basin (max |I - A M| < 0.1, as the reference's test) and
solve to 1e-8 with three refinement sweeps; the full Newton factor
``_inv_factor`` at 181 species
within 1e-5 of max |M| of the JAX ``_inv_factor_one``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _newton_matrices(B, n, seed):
    """Equilibrated, diagonally dominant Newton matrices I - cJ."""
    from kinetica_tpu_torch.ops.linalg import _equilibrate
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, n, n)) * 10.0 ** rng.uniform(-2, 4, (B, n, 1))
    J -= np.eye(n) * (np.abs(J).sum(axis=2, keepdims=True) + 1.0)
    c = 10.0 ** rng.uniform(-4, -1, (B, 1, 1))
    return _equilibrate(torch.as_tensor(np.eye(n) - c * J))[0].numpy()


def _near_identity(B, n, seed):
    rng = np.random.default_rng(seed)
    return (np.eye(n) + (0.5 / np.sqrt(n)) * rng.standard_normal((B, n, n))
            ).astype(np.float32)


def _ref(A):
    from kinetica_tpu.ops.pallas_linalg import schur_inverse
    return np.asarray(jax.vmap(lambda a: schur_inverse(a, interpret=True))(
        jnp.asarray(A, jnp.float32)))


def _port(A):
    from kinetica_tpu_torch.ops.gj_inverse import schur_inverse
    return schur_inverse(torch.as_tensor(A, dtype=torch.float32)).numpy()


def _rel_fro(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (np.linalg.norm((a - b).reshape(len(a), -1), axis=1)
            / np.linalg.norm(b.reshape(len(b), -1), axis=1))


def _resid(A, M):
    n = A.shape[-1]
    return np.abs(np.eye(n) - A.astype(np.float64) @ M.astype(np.float64)
                  ).max(axis=(1, 2))


@pytest.mark.parametrize("n,B,family", [(181, 3, "newton"), (181, 2, "near_id"),
                                        (300, 2, "newton"), (300, 4, "near_id")])
def test_matches_pallas_interpret(n, B, family):
    make = _newton_matrices if family == "newton" else _near_identity
    A = make(B, n, seed=n + B)
    M, M_ref = _port(A), _ref(A)
    assert M.shape == (B, n, n) and M.dtype == np.float32
    assert np.all(_rel_fro(M, M_ref) <= 1e-5)
    assert np.all(_resid(A, M) < 1e-3)


def test_refinable_on_stiff_matrix():
    """The reference's stiff case (rows scaled over 9 decades): the block-
    pivoted factor lands in Newton-Schulz's basin (the reference measured
    ~1e-2 here), Newton-Schulz takes the reference's decision on it (its
    proxy eps32 max|M| ~ 2e-5 is below the 1e-3 gate in both, so both
    leave the factor as it is), and three refinement sweeps of a solve
    reach the f64 solution, as the reference's test requires."""
    from kinetica_tpu.ops.dd import newton_schulz_refine as ref_refine
    from kinetica_tpu_torch.ops.linalg import _equilibrate, newton_schulz_refine
    rng = np.random.default_rng(2)
    n = 181
    J = rng.standard_normal((n, n)) * (10.0 ** rng.uniform(0, 9, (n, 1)))
    As = _equilibrate(torch.as_tensor(np.eye(n) - 1e-3 * J)[None])[0]
    As64 = As[0].double().numpy()
    M = _port(As.numpy())
    assert _resid(As.numpy(), M)[0] < 0.1
    M_r, rn = newton_schulz_refine(torch.as_tensor(M), As)
    M_ref = _ref(As.numpy())[0]
    M_ref_r, rn_ref = ref_refine(jnp.asarray(M_ref), jnp.asarray(As[0].numpy()))
    assert float(rn[0]) == float(rn_ref)
    assert np.array_equal(M_r.numpy(), M)
    assert np.array_equal(np.asarray(M_ref_r), M_ref)
    Minv = M[0].astype(np.float64)
    b = rng.standard_normal(n)
    x = Minv @ b
    for _ in range(3):
        x += Minv @ (b - As64 @ x)
    ref = np.linalg.solve(As64, b)
    np.testing.assert_allclose(x, ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())


def test_inv_factor_matches_jax_at_181_species(monkeypatch):
    """The whole Newton factor (equilibrate, Schur, Newton-Schulz, scales)
    on Newton systems of the 181-species Jacobian at c |J| of 1 to 1e3;
    before the Schur composition the port raised here."""
    monkeypatch.setenv("KINETICA_NS_RESIDUAL", "f64dot")
    from kinetica_tpu.calculators.builtin import PrecalculatedArrheniusCalculator
    from kinetica_tpu.models.mass_action import build_mass_action
    from kinetica_tpu.ops.linalg import _inv_factor_one, _newton_matrix
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.ops.linalg import _inv_factor
    from kinetica_tpu_torch.ops.linalg import _newton_matrix as newton_matrix
    sd, rd, Ea, A = synthetic_pyrolysis_network(60, target_reactions=300)
    assert sd.n == 181
    net = build_mass_action(rd, sd.n)
    rng = np.random.default_rng(5)
    B = 3
    u = 10.0 ** rng.uniform(-10, -1, (B, sd.n))
    k = np.asarray(PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)(
        jnp.asarray(rng.uniform(700, 1300, B))))
    J = np.asarray(jax.vmap(net.jac)(jnp.asarray(u), jnp.asarray(k))
                   ).astype(np.float32)
    # c |J| from 1 to 1e3, as the nc=60 sweep's steps reach: the coupling
    # blocks and Newton-Schulz then shape the factor
    c = 10.0 ** rng.uniform(0, 3, B) / np.abs(J).max(axis=(1, 2))
    M_ref = np.asarray(jax.vmap(lambda J1, c1: _inv_factor_one(
        _newton_matrix(J1, c1)))(jnp.asarray(J), jnp.asarray(c)))
    M = _inv_factor(newton_matrix(torch.as_tensor(J), torch.as_tensor(c)))
    M = M.numpy()
    scale = np.abs(M_ref).max(axis=(1, 2))
    assert np.all(np.abs(M - M_ref).max(axis=(1, 2)) <= 1e-5 * scale)


def test_up_to_128_is_the_gauss_jordan_inverse():
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse, schur_inverse
    A = torch.as_tensor(_near_identity(2, 128, seed=1))
    assert torch.equal(schur_inverse(A), gj_inverse(A))


@pytest.mark.parametrize("what", ["f16", "too_wide", "not_square"])
def test_guard_rejects_bad_inputs(what):
    from kinetica_tpu_torch.ops.gj_inverse import schur_inverse
    bad = {
        "f16": torch.eye(200, dtype=torch.float16)[None],
        "too_wide": torch.eye(513)[None],
        "not_square": torch.ones(1, 200, 199),
    }[what]
    with pytest.raises((TypeError, ValueError)):
        schur_inverse(bad)


def test_cpu_call_launches_nothing():
    from kinetica_tpu_torch.ops import gj_inverse as mod
    mod.launches = 0
    mod.schur_inverse(torch.as_tensor(_near_identity(1, 181, seed=0)))
    assert mod.launches == 0
