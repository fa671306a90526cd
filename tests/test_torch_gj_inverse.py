"""Kernel 2 (batched Gauss-Jordan inverse): its plain version against the
reference ``_gj_call(..., interpret=True)`` of the JAX package.

Both eliminate in the same order with the same pivot rule and clamp, in
f32; only the rounding differs (fused multiply-adds, reciprocal). The
tolerance is 1e-5 in relative Frobenius norm per member.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _newton_matrices(B, n, seed):
    """Equilibrated Newton matrices I - cJ of a random stiff Jacobian."""
    from kinetica_tpu_torch.ops.linalg import _equilibrate
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, n, n)) * 10.0 ** rng.uniform(-2, 4, (B, n, 1))
    J -= np.eye(n) * (np.abs(J).sum(axis=2, keepdims=True) + 1.0)
    c = 10.0 ** rng.uniform(-4, -1, (B, 1, 1))
    A = np.eye(n) - c * J
    As, _, _ = _equilibrate(torch.as_tensor(A))
    return As.numpy()


def _ref(A):
    from kinetica_tpu.ops.pallas_linalg import _gj_call
    return np.asarray(_gj_call(jnp.asarray(A, jnp.float32), interpret=True))


def _port(A):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse
    return gj_inverse(torch.as_tensor(A, dtype=torch.float32)).numpy()


def _rel_fro(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (np.linalg.norm((a - b).reshape(len(a), -1), axis=1)
            / np.linalg.norm(b.reshape(len(b), -1), axis=1))


@pytest.mark.parametrize("n", [5, 19, 73])
def test_newton_matrices_match_reference(n):
    A = _newton_matrices(6, n, seed=n)
    M, M_ref = _port(A), _ref(A)
    assert np.all(_rel_fro(M, M_ref) <= 1e-5)
    resid = np.abs(np.eye(n) - A.astype(np.float64) @ M.astype(np.float64))
    assert resid.max() < 1e-3


def test_pivot_tie_takes_first_row():
    # column 0 holds |a| = 2 in rows 1 and 3: both pick row 1
    A = np.array([[[0.5, 1.0, 0.0, 2.0],
                   [2.0, 0.0, 1.0, 0.0],
                   [1.0, 3.0, 0.0, 1.0],
                   [-2.0, 1.0, 4.0, 0.0]]], dtype=np.float32)
    M, M_ref = _port(A), _ref(A)
    assert np.all(_rel_fro(M, M_ref) <= 1e-5)
    np.testing.assert_allclose(A[0] @ M[0], np.eye(4), atol=1e-5)


def test_singular_member_is_finite_and_equal():
    A = _newton_matrices(3, 7, seed=11)
    A[1, :, 2] = 0.0                      # exactly singular member
    M, M_ref = _port(A), _ref(A)
    assert np.all(np.isfinite(M)) and np.all(np.isfinite(M_ref))
    assert np.all(_rel_fro(M, M_ref) <= 1e-5)


@pytest.mark.parametrize("n", [1, 33, 53, 73, 127, 128])
def test_edge_cases_match_reference(n):
    """The kernel's edge cases (``testing.kernel_cases``): a well-conditioned
    member, a pivot tie in column 0, a NaN column and a zero column.
    Tolerance as above, norms in f64 (the singular member is ~1e30). In a
    NaN column the JAX kernel selects no pivot row (a zero pivot row, which
    may leave the member finite) and the port keeps row k (its rule on the
    card too), so that member is not compared: the port's is all NaN, and
    no other member is touched."""
    from kinetica_tpu_torch.testing.kernel_cases import (GJ_EDGE_WIDTHS,
                                                          gj_edge_cases)
    assert n in GJ_EDGE_WIDTHS
    A, names = gj_edge_cases(n, seed=n)
    M, M_ref = _port(A), _ref(A)
    nan = names.index("nan_column")
    assert np.all(np.isnan(M[nan]))
    keep = [i for i in range(len(names)) if i != nan]
    assert np.all(np.isfinite(M[keep])) and np.all(np.isfinite(M_ref[keep]))
    assert np.all(_rel_fro(M[keep], M_ref[keep]) <= 1e-5)
    for name in ("random", "tie"):
        if name in names:
            i = names.index(name)
            resid = np.eye(n) - A[i].astype(np.float64) @ M[i].astype(np.float64)
            assert np.abs(resid).max() < 1e-3


def test_batch_of_one():
    A = _newton_matrices(1, 19, seed=3)
    M = _port(A)
    assert M.shape == (1, 19, 19)
    assert np.all(_rel_fro(M, _ref(A)) <= 1e-5)


# ---- wrapper guards (checked before any device code) ----

@pytest.mark.parametrize("what", ["f64", "noncontig", "not_square", "2d",
                                  "too_wide"])
def test_guard_rejects_bad_inputs(what):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse
    bad = {
        "f64": torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous(),
        "noncontig": torch.eye(4).expand(2, 4, 4),
        "not_square": torch.ones(2, 4, 5),
        "2d": torch.eye(4),
        "too_wide": torch.eye(129).expand(1, 129, 129).contiguous(),
    }[what]
    with pytest.raises((TypeError, ValueError)) as err:
        gj_inverse(bad)
    if what == "too_wide":
        assert "Schur" in str(err.value)


def test_cpu_call_launches_nothing():
    from kinetica_tpu_torch.ops import gj_inverse as mod
    mod.launches = 0
    mod.gj_inverse(torch.eye(3).expand(2, 3, 3).contiguous())
    assert mod.launches == 0
