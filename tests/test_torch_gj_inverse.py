"""Kernel 2 (batched Gauss-Jordan inverse): its plain version against the
reference ``_gj_call(..., interpret=True)`` of the JAX package.

Both eliminate in the same order with the same pivot rule, clamp and
rounding: the pivot row scaled by a reciprocal, the row exchange by
arithmetic (``row_m + (row_k - row_m)``) and each update rounded once (a
fused multiply-add on XLA's CPU backend). So the results are held equal
bit for bit, except the member with a NaN column (the port's rule differs
there on purpose). On the near-singular Newton matrices of
``testing.kernel_cases.near_singular_newton`` they are held equal once
subnormals are flushed, and bit for bit when the port runs in the
reference's subnormal mode: XLA's CPU runtime flushes subnormal inputs
and results to zero, the port does not. The block-Schur composition on
such matrices: relative Frobenius <= 1e-5 (its f32 matrix products may
round differently).
"""
import contextlib

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
    assert np.array_equal(M, M_ref)
    resid = np.abs(np.eye(n) - A.astype(np.float64) @ M.astype(np.float64))
    assert resid.max() < 1e-3


def test_pivot_tie_takes_first_row():
    # column 0 holds |a| = 2 in rows 1 and 3: both pick row 1
    A = np.array([[[0.5, 1.0, 0.0, 2.0],
                   [2.0, 0.0, 1.0, 0.0],
                   [1.0, 3.0, 0.0, 1.0],
                   [-2.0, 1.0, 4.0, 0.0]]], dtype=np.float32)
    M, M_ref = _port(A), _ref(A)
    assert np.array_equal(M, M_ref)
    np.testing.assert_allclose(A[0] @ M[0], np.eye(4), atol=1e-5)


def test_singular_member_is_finite_and_equal():
    A = _newton_matrices(3, 7, seed=11)
    A[1, :, 2] = 0.0                      # exactly singular member
    M, M_ref = _port(A), _ref(A)
    assert np.all(np.isfinite(M)) and np.all(np.isfinite(M_ref))
    assert np.array_equal(M, M_ref)


@pytest.mark.parametrize("n", [1, 33, 53, 73, 127, 128])
def test_edge_cases_match_reference(n):
    """The kernel's edge cases (``testing.kernel_cases``): a well-conditioned
    member, a pivot tie in column 0, a NaN column, a zero column and a
    near-singular Newton matrix, equal bit for bit (the singular member is
    ~1e30). In a NaN column the JAX kernel selects no pivot row (a zero
    pivot row, which may leave the member finite) and the port keeps row
    k (its rule on the card too), so that member is not compared: the
    port's is all NaN, and no other member is touched."""
    from kinetica_tpu_torch.testing.kernel_cases import (GJ_EDGE_WIDTHS,
                                                          gj_edge_cases)
    assert n in GJ_EDGE_WIDTHS
    A, names = gj_edge_cases(n, seed=n)
    M, M_ref = _port(A), _ref(A)
    nan = names.index("nan_column")
    assert np.all(np.isnan(M[nan]))
    keep = [i for i in range(len(names)) if i != nan]
    assert np.all(np.isfinite(M[keep])) and np.all(np.isfinite(M_ref[keep]))
    assert np.array_equal(M[keep], M_ref[keep])
    for name in ("random", "tie"):
        if name in names:
            i = names.index(name)
            resid = np.eye(n) - A[i].astype(np.float64) @ M[i].astype(np.float64)
            assert np.abs(resid).max() < 1e-3


def test_batch_of_one():
    A = _newton_matrices(1, 19, seed=3)
    M = _port(A)
    assert M.shape == (1, 19, 19)
    assert np.array_equal(M, _ref(A))


def _round_f32(x):
    """The f32 nearest the rational x, ties to even."""
    from fractions import Fraction
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fused_sub_rounds_once():
    """The plain version's update a - b c against the exact value rounded
    once to f32: random operands, results in the subnormal range, and
    a = 1 + 2^-23, b = 2^-24 (1 + 2^-23), c = 1 - 2^-23, whose exact
    result lies 2^-70 above an f32 midpoint: rounded to f64 first it lands
    on the midpoint and rounds to even, 1.0, one ulp off."""
    from fractions import Fraction

    from kinetica_tpu_torch.ops.gj_inverse import _fused_sub
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(400) * 10.0 ** rng.uniform(-3, 3, 400))
    b = (rng.standard_normal(400) * 10.0 ** rng.uniform(-3, 3, 400))
    c = (rng.standard_normal(400) * 10.0 ** rng.uniform(-3, 3, 400))
    a[:100] *= 1e-38                         # subnormal results
    b[:100] *= 1e-20
    c[:100] *= 1e-20
    a = np.append(a, 1 + 2.0 ** -23).astype(np.float32)
    b = np.append(b, 2.0 ** -24 * (1 + 2.0 ** -23)).astype(np.float32)
    c = np.append(c, 1 - 2.0 ** -23).astype(np.float32)
    got = _fused_sub(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) - Fraction(float(y))
                                * Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    assert np.array_equal(got, want)
    assert got[-1] == np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(a[-1]) - np.float64(b[-1]) * c[-1]) == 1.0
    tiny = np.finfo(np.float32).tiny
    assert np.sum((np.abs(want) < tiny) & (want != 0)) > 50


@contextlib.contextmanager
def _flush_subnormals():
    """The reference's subnormal mode on this thread (flush to zero,
    subnormal operands as zero), as XLA's CPU runtime runs."""
    assert torch.set_flush_denormal(True), "no flush-to-zero on this CPU"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _flushed(M):
    return np.where(np.abs(M) < np.finfo(np.float32).tiny, 0.0, M)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [19, 73])
def test_near_singular_newton_matrices_match_reference(n, seed):
    """48 equilibrated I - c J of a conserved network, singular or nearly
    so in f32 (``kernel_cases.near_singular_newton``). An elimination
    that copies rows in the exchange, its product and difference rounded
    apart, puts max|M| of some members at the 1e30 clamp here."""
    from kinetica_tpu_torch.testing.kernel_cases import near_singular_newton
    A = near_singular_newton(48, n, seed)
    M, M_ref = _port(A), _ref(A)
    assert np.array_equal(_flushed(M), _flushed(M_ref))
    assert np.array_equal(np.abs(M).max(axis=(1, 2)),
                          np.abs(M_ref).max(axis=(1, 2)))
    with _flush_subnormals():
        M_ftz = _port(A)
    assert np.array_equal(M_ftz, M_ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_near_singular_schur_matches_reference(seed):
    """The block-Schur inverse at n = 181 (blocks 128 + 53) on the same
    construction, against the reference's ``schur_inverse(interpret=True)``
    (an elimination that copies rows in the exchange puts these members
    far outside it)."""
    import jax
    from kinetica_tpu.ops.pallas_linalg import schur_inverse as ref_schur
    from kinetica_tpu_torch.ops.gj_inverse import schur_inverse
    from kinetica_tpu_torch.testing.kernel_cases import near_singular_newton
    A = near_singular_newton(8, 181, seed)
    M = schur_inverse(torch.as_tensor(A)).numpy()
    M_ref = np.asarray(jax.vmap(lambda a: ref_schur(a, interpret=True))(
        jnp.asarray(A)))
    assert np.all(np.isfinite(M))
    assert np.all(_rel_fro(M, M_ref) <= 1e-5)


# ---- wrapper guards (checked before any device code) ----

@pytest.mark.parametrize("what", ["f16", "noncontig", "not_square", "2d",
                                  "too_wide"])
def test_guard_rejects_bad_inputs(what):
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse
    bad = {
        "f16": torch.eye(4, dtype=torch.float16).expand(2, 4, 4).contiguous(),
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
