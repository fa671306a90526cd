"""Batched Gauss-Jordan inverse: kernel 2 of the port (``csrc/gj_inverse.cu``).

Counterpart of ``kinetica_tpu/ops/pallas_linalg.py::gj_inverse`` (kernel
``_gj_batch_kernel``, launched by ``_gj_call``): the f32 explicit inverse of a
batch of (n, n) matrices by Gauss-Jordan with partial pivoting. The pivot
of column k is the first row i >= k that holds the column's largest
|a_ik|; a pivot with |p| < 1e-30 is clamped to +-1e-30 (0 -> +1e-30), so a
singular member comes out finite instead of NaN.

On a CUDA tensor :func:`gj_inverse` launches the kernel or raises; on a
CPU tensor it runs :func:`gj_inverse_plain`, the same elimination as a
batched column loop in PyTorch. The kernel works in place and rounds
each product and difference as the plain version does, so the two agree
bit for bit. ``torch.linalg.inv`` is not a stand-in: it has no pivot
clamp.

The kernel takes n <= 128 (one 512-thread block holds the matrix in its
registers, 32 floats a thread). Wider systems, up to 512, go through
:func:`schur_inverse`, the reference's block-Schur composition
(``pallas_linalg.py::schur_inverse``): Gauss-Jordan kernel launches on
the diagonal blocks, f32 matrix products for the coupling terms.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load_library

MAX_N = 128
MAX_SCHUR_N = 512
PIVOT_FLOOR = 1e-30

# kernel launches since the last reset (the plain path never counts)
launches = 0


def _check(A: torch.Tensor) -> None:
    if A.dtype != torch.float32:
        raise TypeError(f"gj_inverse: A must be float32, got {A.dtype}")
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
    """The kernel's elimination as a batched column loop (any device)."""
    B, n, _ = A.shape
    dev = A.device
    eye = torch.eye(n, dtype=A.dtype, device=dev).expand(B, n, n)
    aug = torch.cat([A, eye], dim=2)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(B, device=dev)
    for k in range(n):
        score = torch.where(rows >= k, aug[:, :, k].abs(),
                            torch.full_like(aug[:, :, k], -1.0))
        top = score.amax(dim=1, keepdim=True)
        m = torch.where(score >= top, rows, n).amin(dim=1)
        m = torch.where(m < n, m, k)                     # NaN column
        row_k = aug[:, k, :].clone()
        row_m = aug[lanes, m, :]
        piv = row_m[:, k]
        piv = torch.where(piv.abs() < PIVOT_FLOOR,
                          torch.where(piv < 0, -PIVOT_FLOOR, PIVOT_FLOOR)
                          .to(piv.dtype), piv)
        row_p = row_m * (1.0 / piv)[:, None]
        aug[lanes, m, :] = row_k                         # swap (m == k: no-op)
        f = aug[:, :, k].clone()
        f[:, k] = 0.0
        aug = aug - f[:, :, None] * row_p[:, None, :]
        aug[:, k, :] = row_p
    return aug[:, :, n:].contiguous()


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 -> (B, n, n) f32 inverses, n <= 128."""
    _check(A)
    if A.device.type == "cpu":
        return gj_inverse_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"gj_inverse: unsupported device {A.device}")
    global launches
    out = torch.empty_like(A)
    if A.shape[0] == 0:
        return out
    err = _library().gj_inverse_launch(
        A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[1],
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
    if A.dtype != torch.float32:
        raise TypeError(f"schur_inverse: A must be float32, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(
            f"schur_inverse: A must be (B, n, n), got {tuple(A.shape)}")
    if A.shape[1] > MAX_SCHUR_N:
        raise ValueError(f"schur_inverse: n = {A.shape[1]} > {MAX_SCHUR_N}")


def schur_inverse(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 -> (B, n, n) f32 inverses, n <= 512, by 2x2 blocks.

    With A = [[A11, A12], [A21, A22]], A11 of n1 = 128 max(1, (n // 2) //
    128) rows, and S = A22 - A21 A11^-1 A12::

        A^-1 = [[A11^-1 - M12 T, M12], [M21, S^-1]],
        T = A21 A11^-1, M12 = -(A11^-1 A12) S^-1, M21 = -S^-1 T,

    recursively, so every diagonal block that reaches :func:`gj_inverse`
    is at most 128 wide (181 -> 128 + 53, 512 -> (128 + 128) + (128 +
    128)). The coupling products are plain f32 matmuls (TF32 is off, the
    reference's ``Precision.HIGHEST``). Pivoting stays inside the diagonal
    blocks, so this is no general pivoted inverse: the Newton factor
    equilibrates A first and refines the result by Newton-Schulz. At n <=
    128 it is :func:`gj_inverse` itself.
    """
    _check_schur(A)
    return _schur(A, gj_inverse)


def schur_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """The same composition over :func:`gj_inverse_plain` (any device)."""
    _check_schur(A)
    return _schur(A, gj_inverse_plain)


def _library() -> ctypes.CDLL:
    lib = load_library("gj_inverse")
    fn = lib.gj_inverse_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
