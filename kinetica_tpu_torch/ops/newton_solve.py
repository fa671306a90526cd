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
It spreads a lane over a thread-block cluster of ``cs`` blocks, each
holding a run of the lane's rows of M and J in shared memory; the
cluster size comes from :func:`_cluster_plan`, and its result does not
depend on it (bit for bit). A plan the card cannot schedule raises.

Forward mode carries the reference's rule 3 (``_fused_solve_jvp``): the
solve acts as b -> A^-1 b with A = I - c J, so
d(dy) = A^-1 (db + dc (J dy) + c (dJ dy)), computed by one more solve of
the same kind (one more kernel launch on the card) on that right-hand
side; the two matvecs are plain products and the preconditioner's
tangent dM is dropped, as in the reference.

On a CUDA tensor :func:`fused_newton_solve` launches the kernel or
raises; on a CPU tensor it runs :func:`fused_newton_solve_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load_library
from .grid_probe import ensure_grid_supported
from .jvp import has_tangent

MAX_N = 512
STOP_RTOL = 1e-4
NORM_FLOOR = 1e-30
# the kernel's block (8 warps) and cluster sizes
WARPS = 8
CLUSTER_SIZES = (1, 2, 4, 8, 16)

# kernel launches since the last reset (the plain path never counts)
launches = 0
# device index -> (SMs, opt-in shared memory of a block in bytes)
_limits: dict[int, tuple[int, int]] = {}
# (device index, n, B) -> the cluster size, once the card took it
_plans: dict[tuple[int, int, int], int] = {}


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def fused_newton_solve_plain(M: torch.Tensor, J: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor, n_sweeps: int = 4) -> torch.Tensor:
    """The kernel's algorithm as a batched loop with per-lane masks.

    Every sweep is computed for all lanes and merged into the active
    ones, so the loop needs no device-to-host read. Rule 3 on dual inputs.
    """
    return _with_rule(_solve_plain, M, J, b, c, n_sweeps)


def _solve_plain(M, J, b, c, n_sweeps):
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


def _pad4(x: int) -> int:
    return (x + 3) // 4 * 4


def _smem_bytes(n: int, rows: int) -> int:
    """Shared memory of one block owning at most ``rows`` rows (the
    kernel's ``Layout``): b and dy for its rows (f64), its M and J slabs
    with 3 floats of alignment slack each, dy32, r and corr for all n rows
    and the stop test's 2 x 8 partials (f32)."""
    return 2 * rows * 8 + (2 * _pad4(rows * n + 3) + 3 * _pad4(n)
                           + 2 * WARPS) * 4


def _rows(n: int, cs: int) -> int:
    """The most rows a block of a cluster of ``cs`` owns at width n."""
    return -(-n // cs)


def _row_slabs(n: int, cs: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) that each block of a cluster owns, as the kernel
    splits them: rank r owns [r n // cs, (r + 1) n // cs)."""
    return [(r * n // cs, (r + 1) * n // cs) for r in range(cs)]


def _cluster_plan(n: int, B: int, sm_count: int,
                  smem_optin: int) -> tuple[int, int]:
    """(cs, rows_per_block): the blocks a lane is split over, and the most
    rows a block owns.

    The smallest cluster size whose row slabs of M and J, plus the
    vectors, fit in a block's opt-in shared memory; then doubled while the
    batch's B 2cs blocks fit the SMs once and every block keeps at least
    one row per warp (n // 2cs >= 8).
    """
    cs = CLUSTER_SIZES[0]
    while _smem_bytes(n, _rows(n, cs)) > smem_optin:
        if cs == CLUSTER_SIZES[-1]:
            raise ValueError(f"newton_solve: n = {n} does not fit in "
                             f"{CLUSTER_SIZES[-1]} blocks of {smem_optin} B")
        cs *= 2
    while (cs < CLUSTER_SIZES[-1] and B * 2 * cs <= sm_count
           and n // (2 * cs) >= WARPS):
        cs *= 2
    return cs, _rows(n, cs)


def _device_plan(n: int, B: int, device: torch.device) -> int:
    """The cluster size for this shape on ``device``; raises where the card
    cannot hold even one such cluster. Cached by shape: the step loop
    calls it before every launch."""
    idx = _index(device)
    cs = _plans.get((idx, n, B))
    if cs is not None:
        return cs
    if idx not in _limits:
        sm, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            check_launch(_library().newton_solve_device_limits(
                ctypes.byref(sm), ctypes.byref(smem)), "newton_solve device query")
        _limits[idx] = (sm.value, smem.value)
    cs, rows = _cluster_plan(n, B, *_limits[idx])
    if max_clusters(n, cs, device) < 1:
        raise RuntimeError(
            f"newton_solve: a cluster of {cs} blocks ({_smem_bytes(n, rows)} B "
            f"of shared memory each) for n = {n}, B = {B} cannot be scheduled "
            f"on {torch.cuda.get_device_name(idx)}")
    _plans[(idx, n, B)] = cs
    return cs


def max_clusters(n: int, cs: int, device: torch.device) -> int:
    """The clusters of ``cs`` blocks at width n that ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    held = ctypes.c_int()
    with torch.cuda.device(_index(device)):
        check_launch(_library().newton_solve_max_clusters(
            n, cs, ctypes.byref(held)), "newton_solve occupancy query")
    return held.value


def cluster_sizes(n: int, device) -> list[int]:
    """Every cluster size whose row slabs at width n fit a block's shared
    memory on ``device`` (the sizes :func:`launch` takes)."""
    device = torch.device(device)
    _device_plan(n, 1, device)
    return [cs for cs in CLUSTER_SIZES
            if _smem_bytes(n, _rows(n, cs)) <= _limits[_index(device)][1]]


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


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
    return _with_rule(_solve, M, J, b, c, n_sweeps)


def _with_rule(solve, M, J, b, c, n_sweeps):
    if has_tangent(M, J, b, c):
        return _SolveRule.apply(M, J, b, c, n_sweeps, solve)
    return solve(M, J, b, c, n_sweeps)


class _SolveRule(torch.autograd.Function):
    """Rule 3: the tangent is ``solve`` on db + dc (J dy) + c (dJ dy)."""

    @staticmethod
    def forward(ctx, M, J, b, c, n_sweeps, solve):
        dy = solve(M, J, b, c, n_sweeps)
        ctx.save_for_forward(M, J, c, dy)
        ctx.n_sweeps, ctx.solve = n_sweeps, solve
        return dy

    @staticmethod
    def jvp(ctx, dM, dJ, db, dc, *_):
        M, J, c, dy = ctx.saved_tensors
        rhs_t = torch.zeros_like(dy) if db is None else db
        if dc is not None:
            rhs_t = rhs_t + dc[:, None] * _matvec(J, dy.to(J.dtype)).to(dy.dtype)
        if dJ is not None:
            rhs_t = rhs_t + c[:, None] * _matvec(dJ, dy.to(dJ.dtype)).to(dy.dtype)
        return ctx.solve(M, J, rhs_t.contiguous(), c, ctx.n_sweeps)


def _solve(M, J, b, c, n_sweeps):
    if b.device.type == "cpu":
        return _solve_plain(M, J, b, c, n_sweeps)
    if b.device.type != "cuda":
        raise ValueError(f"newton_solve: unsupported device {b.device}")
    ensure_grid_supported(b.device)
    if b.shape[0] == 0:
        return torch.empty_like(b)
    return launch(M, J, b, c, n_sweeps,
                  _device_plan(b.shape[1], b.shape[0], b.device))


def launch(M, J, b, c, n_sweeps: int, cs: int) -> torch.Tensor:
    """One kernel launch at cluster size ``cs`` on checked CUDA inputs (B >=
    1); :func:`fused_newton_solve` passes the planned size, the kernel
    comparisons every size the card takes."""
    global launches
    dy = torch.empty_like(b)
    err = _library().newton_solve_launch(
        M.data_ptr(), J.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
        b.shape[0], b.shape[1], n_sweeps, cs,
        torch.cuda.current_stream(b.device).cuda_stream)
    check_launch(err, f"newton_solve (cluster of {cs})")
    launches += 1
    return dy


def _library() -> ctypes.CDLL:
    lib = load_library("newton_solve")
    fn = lib.newton_solve_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptr = ctypes.POINTER(ctypes.c_int)
        lib.newton_solve_device_limits.argtypes = [ptr, ptr]
        lib.newton_solve_device_limits.restype = ctypes.c_int
        lib.newton_solve_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ptr]
        lib.newton_solve_max_clusters.restype = ctypes.c_int
    return lib
