"""Batched Gauss-Jordan inverse: kernel 2 of the port (``csrc/gj_inverse.cu``).

Counterpart of ``kinetica_tpu/ops/pallas_linalg.py::gj_inverse`` (kernel
``_gj_batch_kernel``, launched by ``_gj_call``): the f32 explicit inverse of a
batch of (n, n) matrices by Gauss-Jordan with partial pivoting. The same
elimination runs in f64 on an f64 batch (``gj_inverse64_kernel``), where
the TPU has no f64: the Newton factor's inverse (:mod:`.linalg`), the only
caller on the port's solve path. The f32 instantiation has no caller
there; it is kept as the witness that the elimination is the JAX
kernel's, bit for bit (the CPU tests against the JAX package, the card's
kernel checks). The pivot
of column k is the first row i >= k that holds the column's largest
|a_ik|; a pivot with |p| < 1e-30 is clamped to +-1e-30 (0 -> +1e-30), so a
singular member comes out finite instead of NaN.

The elimination is the reference's, rounding for rounding, as its CPU
run computes it: the pivot row is scaled by ``1 / p``; row m takes old
row k by arithmetic, ``row_m + (row_k - row_m)``, two f32 operations; and
every row's update ``base - f * row_p`` is rounded once (a fused
multiply-add). An exact copy in the exchange, or a product and a
difference rounded apart, is a different function exactly where it
matters: on a Newton matrix that is singular in f32 a later pivot then
cancels to exactly 0, the clamp turns the inverse into ~1e30 and Newton
fails. XLA's CPU runtime flushes subnormal operands and results to zero
and the port does not, so where a subnormal arises mid-elimination the
two can part in entries far below max|M|; run with ``torch.set_flush_denormal``
the port's result equals the reference's bit for bit on the near-singular
Newton matrices of ``testing.kernel_cases.near_singular_newton``.

On a CUDA tensor :func:`gj_inverse` launches the kernel or raises; on a
CPU tensor it runs :func:`gj_inverse_plain`, the same in-place
elimination as a batched column loop in PyTorch (its multiply-add in f64,
rounded to odd where rounding on to f32 could part from one rounding), so
the two agree bit for bit. In f64 both round the update's product and
difference apart, and agree bit for bit too. ``torch.linalg.inv`` is not
a stand-in: it has no pivot clamp.

The kernel takes n <= 128 (one 512-thread block holds the matrix in its
registers, 32 floats a thread). Wider systems, up to 512, go through
:func:`schur_inverse`, the reference's block-Schur composition
(``pallas_linalg.py::schur_inverse``): Gauss-Jordan kernel launches on
the diagonal blocks, matrix products in A's dtype for the coupling terms.

Forward mode: both inverses carry the reference's rule
(``_gj_inverse_jvp``), d(A^-1) = -M dA M with M the computed inverse, on
either device. The reference's Schur gets its tangent by composing the
rule with its matmuls; the port's calls the kernel through ctypes, so it
carries the rule itself.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load_library
from .jvp import has_tangent, inverse_tangent

MAX_N = 128
MAX_SCHUR_N = 512
PIVOT_FLOOR = 1e-30
DTYPES = (torch.float32, torch.float64)

# kernel launches since the last reset (the plain path never counts)
launches = 0


def _check(A: torch.Tensor) -> None:
    if A.dtype not in DTYPES:
        raise TypeError(f"gj_inverse: A must be float32 or float64, got "
                        f"{A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"gj_inverse: A must be (B, n, n), got {tuple(A.shape)}")
    if A.shape[1] > MAX_N:
        raise ValueError(
            f"gj_inverse: n = {A.shape[1]} > {MAX_N}; wider systems (up to "
            f"{MAX_SCHUR_N}) go through the block-Schur composition, "
            "schur_inverse")
    if not A.is_contiguous():
        raise ValueError("gj_inverse: A must be contiguous")


def gj_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """The kernel's elimination as a batched column loop (any device),
    with rule 1 on a dual input."""
    return _with_rule(A, _gj_plain)


def _gj_plain(A: torch.Tensor) -> torch.Tensor:
    B, n, _ = A.shape
    dev = A.device
    x = A.clone()
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(B, device=dev)
    pivots = []
    for k in range(n):
        # column k is read, then holds the inverse's column from here on
        col = x[:, :, k].clone()
        x[:, :, k] = 0.0
        score = torch.where(rows >= k, col.abs(), torch.full_like(col, -1.0))
        top = score.amax(dim=1, keepdim=True)
        m = torch.where(score >= top, rows, n).amin(dim=1)
        m = torch.where(m < n, m, k)                     # NaN column
        piv = col[lanes, m]
        floor = torch.full_like(piv, PIVOT_FLOOR)
        piv = torch.where(piv.abs() < PIVOT_FLOOR,
                          torch.where(piv < 0, -floor, floor), piv)
        inv = 1.0 / piv
        row_m = x[lanes, m, :]
        row_k = x[:, k, :].clone()
        row_p = row_m * inv[:, None]
        row_p[:, k] = inv
        f = col.clone()
        f[lanes, m] = col[:, k]
        # the exchange by arithmetic, as the reference's: row m becomes
        # row_m + (row_k - row_m) (m == k: row k, overwritten below)
        x[lanes, m, :] = row_m + (row_k - row_m)
        x = _fused_sub(x, f[:, :, None], row_p[:, None, :])
        x[:, k, :] = row_p
        pivots.append(m)
    # undo the exchanges as column swaps (k, m_k) in reverse order
    dst = rows.expand(B, n)
    for k in range(n - 1, -1, -1):
        m = pivots[k][:, None]
        dst = torch.where(dst == k, m, torch.where(dst == m, k, dst))
    return torch.empty_like(x).scatter_(2, dst[:, None, :].expand(B, n, n), x)


# f64 bits below f32 precision (normal range), and their pattern at an
# f32 midpoint
_BELOW_F32 = (1 << 29) - 1
_MIDPOINT = 1 << 28
_F32_MIN = 2.0 ** -126


def _fused_sub(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """a - b c of f32 tensors (broadcast), rounded once to f32: a fused
    multiply-add, as the kernel's ``__fmaf_rn`` and the reference's. Of
    f64 tensors, the product and the difference rounded apart, as the f64
    kernel's.

    The product of two f32 values is exact in f64, so s = a - b c in f64
    is the exact value rounded once. Rounding s on to f32 can part from
    rounding the exact value only where s is an f32 midpoint (or lies in
    the f32 subnormal range). Those entries are rounded to odd in f64
    first (an inexact, even s moves one ulp toward the exact value, its
    TwoSum error), which with 29 spare bits rounds to f32 as the exact
    value does."""
    if a.dtype == torch.float64:
        return a - b * c
    a64 = a.double()
    p = b.double() * c.double()
    s = a64 - p
    t = s - a64
    err = (a64 - (s - t)) - (p + t)
    bits = s.view(torch.int64)
    odd = (bits & _BELOW_F32) == _MIDPOINT
    odd |= (s.abs() < _F32_MIN) & (s != 0)
    nudge = odd & (err != 0) & ((bits & 1) == 0) & s.isfinite()
    s = torch.where(nudge, torch.nextafter(s, err * float("inf")), s)
    return s.to(a.dtype)


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 or f64 -> (B, n, n) inverses of its dtype, n <= 128."""
    _check(A)
    return _with_rule(A, _gj_inverse)


class _InverseRule(torch.autograd.Function):
    """Rule 1: the primal from ``inv``, the tangent -M dA M."""

    @staticmethod
    def forward(ctx, A, inv):
        M = inv(A)
        ctx.save_for_forward(M)
        return M

    @staticmethod
    def jvp(ctx, dA, _):
        M, = ctx.saved_tensors
        return inverse_tangent(M, dA)


def _gj_inverse(A: torch.Tensor) -> torch.Tensor:
    if A.device.type == "cpu":
        return _gj_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"gj_inverse: unsupported device {A.device}")
    global launches
    out = torch.empty_like(A)
    if A.shape[0] == 0:
        return out
    lib = _library()
    launch = (lib.gj_inverse_launch if A.dtype == torch.float32
              else lib.gj_inverse64_launch)
    err = launch(A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[1],
                 torch.cuda.current_stream(A.device).cuda_stream)
    check_launch(err, "gj_inverse")
    launches += 1
    return out


def _schur(A: torch.Tensor, inv) -> torch.Tensor:
    n = A.shape[-1]
    if n <= MAX_N:
        return inv(A.contiguous())
    n1 = MAX_N * max(1, (n // 2) // MAX_N)
    A11, A12 = A[:, :n1, :n1], A[:, :n1, n1:]
    A21, A22 = A[:, n1:, :n1], A[:, n1:, n1:]
    I11 = _schur(A11, inv)
    T = A21 @ I11
    S = A22 - T @ A12
    Sinv = _schur(S, inv)
    # the four blocks go straight into the output (no concatenation)
    out = A.new_empty(A.shape)
    M12 = out[:, :n1, n1:]
    torch.neg((I11 @ A12) @ Sinv, out=M12)
    torch.neg(Sinv @ T, out=out[:, n1:, :n1])
    torch.sub(I11, M12 @ T, out=out[:, :n1, :n1])
    out[:, n1:, n1:] = Sinv
    return out


def _check_schur(A: torch.Tensor) -> None:
    if A.dtype not in DTYPES:
        raise TypeError(f"schur_inverse: A must be float32 or float64, got "
                        f"{A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(
            f"schur_inverse: A must be (B, n, n), got {tuple(A.shape)}")
    if A.shape[1] > MAX_SCHUR_N:
        raise ValueError(f"schur_inverse: n = {A.shape[1]} > {MAX_SCHUR_N}")


def schur_inverse(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 or f64 -> (B, n, n) inverses of its dtype, n <= 512,
    by 2x2 blocks.

    With A = [[A11, A12], [A21, A22]], A11 of n1 = 128 max(1, (n // 2) //
    128) rows, and S = A22 - A21 A11^-1 A12::

        A^-1 = [[A11^-1 - M12 T, M12], [M21, S^-1]],
        T = A21 A11^-1, M12 = -(A11^-1 A12) S^-1, M21 = -S^-1 T,

    recursively, so every diagonal block that reaches :func:`gj_inverse`
    is at most 128 wide (181 -> 128 + 53, 512 -> (128 + 128) + (128 +
    128)). The coupling products are plain matmuls in A's dtype (TF32 is
    off, the reference's ``Precision.HIGHEST``). Pivoting stays inside the
    diagonal blocks, so this is no general pivoted inverse: the Newton
    factor equilibrates A first and refines the result by Newton-Schulz.
    At n <= 128 it is :func:`gj_inverse` itself.
    """
    _check_schur(A)
    return _with_rule(A, lambda a: _schur(a, gj_inverse))


def schur_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """The same composition over :func:`gj_inverse_plain` (any device)."""
    _check_schur(A)
    return _with_rule(A, lambda a: _schur(a, gj_inverse_plain))


def _with_rule(A: torch.Tensor, inv) -> torch.Tensor:
    return _InverseRule.apply(A, inv) if has_tangent(A) else inv(A)


def _library() -> ctypes.CDLL:
    lib = load_library("gj_inverse")
    for fn in (lib.gj_inverse_launch, lib.gj_inverse64_launch):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib
