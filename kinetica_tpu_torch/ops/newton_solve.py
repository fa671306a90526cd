"""Fused Newton solve: kernel 4 of the port (``csrc/newton_solve.cu``).

Counterpart of ``kinetica_tpu/ops/pallas_linalg.py::fused_newton_solve``
(kernel ``_newton_solve_kernel``), the ``linsolve="inv_fused"`` choice.
It solves (I - c J) dy = b for every lane in one launch:

* dy = M b, with M the lane's f32 preconditioner inverse (its scales
  folded in; it may have been built at a stale c);
* one mandatory refinement sweep r = b - (dy - c (J dy)), dy += M r, then
  further sweeps while the lane's ||M r||_2 > 1e-4 max(||dy||_2, 1e-30),
  up to ``n_sweeps`` sweeps in all; a lane that stops is frozen.

Both matvecs run in f32 on f32 M and J. The reference carries b, c, the
residual and dy as double-f32 pairs; here they are native f64. The stop
test compares f32 norms, so a lane at the 1e-4 boundary may take one
sweep more in the kernel than in :func:`fused_newton_solve_plain`, which
sums in another order; both then solve to the same bounds.

The kernel takes n <= 512, the widest system the inverse factors take.
The JVP rule of the reference (``_fused_solve_jvp``) is not ported.
On a CUDA tensor :func:`fused_newton_solve` launches the kernel or
raises; on a CPU tensor it runs :func:`fused_newton_solve_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load_library
from .grid_probe import ensure_grid_supported

MAX_N = 512
STOP_RTOL = 1e-4
NORM_FLOOR = 1e-30

# kernel launches since the last reset (the plain path never counts)
launches = 0


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def fused_newton_solve_plain(M: torch.Tensor, J: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor, n_sweeps: int = 4) -> torch.Tensor:
    """The kernel's algorithm as a batched loop with per-lane masks.

    Every sweep is computed for all lanes and merged into the active
    ones, so the loop needs no device-to-host read.
    """
    f32 = torch.float32
    dy = _matvec(M, b.to(f32)).to(b.dtype)
    active = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    for _ in range(n_sweeps):
        Jdy = _matvec(J, dy.to(f32)).to(b.dtype)
        r = b - (dy - c[:, None] * Jdy)
        corr = _matvec(M, r.to(f32))
        dy = torch.where(active[:, None], dy + corr.to(b.dtype), dy)
        n_corr = torch.linalg.vector_norm(corr, dim=1)
        n_dy = torch.linalg.vector_norm(dy.to(f32), dim=1)
        active = active & (n_corr > STOP_RTOL * n_dy.clamp_min(NORM_FLOOR))
    return dy


def _check(M, J, b, c, n_sweeps) -> None:
    if M.dtype != torch.float32 or J.dtype != torch.float32:
        raise TypeError("newton_solve: M and J must be float32, got "
                        f"{M.dtype} and {J.dtype}")
    if b.dtype != torch.float64 or c.dtype != torch.float64:
        raise TypeError("newton_solve: b and c must be float64, got "
                        f"{b.dtype} and {c.dtype}")
    if b.ndim != 2:
        raise ValueError(f"newton_solve: b must be (B, n), got {tuple(b.shape)}")
    B, n = b.shape
    for name, x in (("M", M), ("J", J)):
        if tuple(x.shape) != (B, n, n):
            raise ValueError(f"newton_solve: {name} must be ({B}, {n}, {n}), "
                             f"got {tuple(x.shape)}")
    if tuple(c.shape) != (B,):
        raise ValueError(f"newton_solve: c must be ({B},), got {tuple(c.shape)}")
    if n > MAX_N:
        raise ValueError(f"newton_solve: n = {n} > {MAX_N}")
    if n_sweeps < 1:
        raise ValueError("newton_solve: n_sweeps must be >= 1")
    for name, x in (("M", M), ("J", J), ("b", b), ("c", c)):
        if not x.is_contiguous():
            raise ValueError(f"newton_solve: {name} must be contiguous")
        if x.device != b.device:
            raise ValueError(f"newton_solve: {name} is on {x.device}, b on "
                             f"{b.device}")


def fused_newton_solve(M: torch.Tensor, J: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, n_sweeps: int = 4) -> torch.Tensor:
    """(B, n, n) f32 M and J, (B, n) f64 b, (B,) f64 c -> (B, n) f64 dy."""
    _check(M, J, b, c, n_sweeps)
    if b.device.type == "cpu":
        return fused_newton_solve_plain(M, J, b, c, n_sweeps)
    if b.device.type != "cuda":
        raise ValueError(f"newton_solve: unsupported device {b.device}")
    ensure_grid_supported(b.device)
    global launches
    dy = torch.empty_like(b)
    if b.shape[0] == 0:
        return dy
    err = _library().newton_solve_launch(
        M.data_ptr(), J.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
        b.shape[0], b.shape[1], n_sweeps,
        torch.cuda.current_stream(b.device).cuda_stream)
    check_launch(err, "newton_solve")
    launches += 1
    return dy


def _library() -> ctypes.CDLL:
    lib = load_library("newton_solve")
    fn = lib.newton_solve_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
