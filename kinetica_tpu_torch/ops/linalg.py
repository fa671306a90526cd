"""Newton linear algebra of the stiff solver, batched over lanes.

Counterpart of ``kinetica_tpu/ops/linalg.py`` and of the Newton-Schulz
refinement in ``kinetica_tpu/ops/dd.py``, in the reference's accelerator
form:

* the Newton matrix A = I - c J is built in J's dtype (f32 on the main
  path), equilibrated in f32, inverted in f64 by the Gauss-Jordan kernel
  (:mod:`kinetica_tpu_torch.ops.gj_inverse`; above 128 species by its
  block-Schur composition, up to 512), rounded to f32, refined by
  Newton-Schulz and stored with its scales folded in;
* "inv" and "inv_gated" solve with one f32 matvec through that inverse
  plus exactly two refinement sweeps against native f64 residuals;
  "inv_fused" hands the whole solve, with its adaptive sweeps, to the
  Newton-solve kernel (:mod:`kinetica_tpu_torch.ops.newton_solve`).

Hopper has native f64, so the reference's double-f32 pair residuals are
not carried over: the accurate Newton-Schulz residual is an f64 matmul
(the reference's ``f64dot`` form). For the same reason the inverse is
eliminated in f64, where the reference's TPU eliminates in f32: over long
horizons (large steps, A = I - c J near-singular in f32) the f32
elimination's inverse leaves a residual I - A M far above 1, which
Newton-Schulz cannot refine, and the Newton iteration then stops on
updates that no longer measure its error. The f64 elimination's inverse,
rounded to f32, serves there as an exact one would (the 1095-reaction
network's 4e-3 K/s ramp over 1e5 s, on the CPU: 1.6e-8 of error against
a tight SciPy solve in 1793 steps with the f32 elimination, 3.7e-10 in
862 with the f64 one).

Lane gating: the reference compacts the factor rebuild to the lanes whose
``need`` flag is set with a ``custom_vmap`` rule. Here the needing lanes
are picked with one device-to-host read, factored as a sub-batch, and
copied back with ``index_copy``; the other lanes keep their old factor.

Forward mode: the factor carries the reference's rule 2
(``_inv_factor_jvp``), d(A^-1) = -M dA M with M the refined factor, so a
tangent sees neither the Gauss-Jordan kernel nor the gated Newton-Schulz
sweeps; ``need`` has no tangent. In a gated rebuild the kept lanes keep
their old tangents (zero without ``prev``), the rebuilt lanes take new
ones. The Newton solves are plain tensor arithmetic on M and J, and
"inv_fused" carries rule 3 (:mod:`.newton_solve`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..utils.profiling import span, spanned
from . import host_sync
from .gj_inverse import MAX_SCHUR_N, schur_inverse
from .jvp import has_tangent, inverse_tangent
from .newton_solve import fused_newton_solve

NS_TOL = 3e-4          # Newton-Schulz factor tolerance (max |I - A M|)
NS_PROXY_TOL = 1e-3    # skip refinement when eps32 * max|M| is below this
NS_CAP = 0.03          # upper clamp of the phase-2 gate
NS_MAX_SWEEPS = 4
REFINE_SWEEPS = 2      # per-solve refinement sweeps of "inv" / "inv_gated"
MAX_REFINE = 4         # sweep limit of the adaptive "inv_fused" solve
INV_METHODS = ("inv", "inv_gated", "inv_fused")
EPS32 = 1.2e-7
_gated = True          # the phase-2 gate of ``newton_schulz_refine``

# since the last reset: the factor builds that rebuilt a lane (every
# :func:`newton_factor` call that built one), the lanes they built, the
# batch's Newton-Schulz sweeps (cheap and accurate), and of those the
# accurate ones (an f64 residual each)
factor_builds = 0
factor_lanes = 0
refine_sweeps = 0
refine_accurate_sweeps = 0


def resolve_linsolve(method: str, ns: int) -> str:
    """The linear solve for ``ns`` species.

    "auto" is "inv_gated" up to 512 species on every device (the port's
    accelerator choice) and the f64 "lu" above, as the reference. An
    explicit inverse method above 512 raises: the inverses stop there.
    """
    if method == "auto":
        return "inv_gated" if ns <= MAX_SCHUR_N else "lu"
    if method not in INV_METHODS + ("lu",):
        raise ValueError(f"unknown linsolve {method!r}")
    if method in INV_METHODS and ns > MAX_SCHUR_N:
        raise ValueError(f"linsolve {method!r} supports up to {MAX_SCHUR_N} "
                         f"species, got {ns}; use 'lu' or 'auto'")
    return method


class NewtonFactors(NamedTuple):
    lu: torch.Tensor    # (B, n, n) equilibrated inverse (INV_METHODS) or LU
    piv: torch.Tensor   # (B, n) pivots ("lu"); empty for the inverses
    J: torch.Tensor     # (B, n, n) Jacobian the factor was built from
    c: torch.Tensor     # (B,) c in A = I - c J


def _newton_matrix(J: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """I - c J in J's dtype (c is cast first, as in the reference)."""
    n = J.shape[-1]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    return eye - c.to(J.dtype)[:, None, None] * J


def _equilibrate(A: torch.Tensor):
    """Row then column max-norm scaling of A, in f32 -> (As, dr, dc)."""
    A32 = A.to(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    dr = 1.0 / A32.abs().amax(dim=2).clamp_min(tiny)
    As = A32 * dr[:, :, None]
    dc = 1.0 / As.abs().amax(dim=1).clamp_min(tiny)
    return As * dc[:, None, :], dr, dc


def _rnorm(R: torch.Tensor) -> torch.Tensor:
    return R.abs().amax(dim=(1, 2))


def _residual_f64(A32: torch.Tensor, M32: torch.Tensor) -> torch.Tensor:
    """R = I - A M with a native f64 product (exact f32 -> f64 casts)."""
    n = A32.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=A32.device)
    return (eye - A32.double() @ M32.double()).to(torch.float32)


@spanned("linalg.refine")
def newton_schulz_refine(minv: torch.Tensor, A32: torch.Tensor):
    """Refine approximate f32 inverses ``minv`` of ``A32`` where needed.

    Per lane, as the reference's accelerator path (``dd.py:271-436`` with
    the ``f64dot`` residual and the gated phase 2):

    1. a free proxy ``eps32 * max|M| > NS_PROXY_TOL`` selects the lanes
       worth refining;
    2. up to 3 cheap sweeps M <- M + M (I - A M) with the f32 residual,
       while it measures above ``NS_TOL``;
    3. lanes whose cheap residual is still above its floor estimate
       ``clamp(4 eps32 sqrt(n) max|M|, NS_TOL, NS_CAP)`` take up to
       ``NS_MAX_SWEEPS`` accurate sweeps with the f64 residual, until it
       is below sqrt(0.3 NS_TOL).

    Within :func:`ungated_refinement` step 3 takes every selected lane.

    Returns ``(minv, rn)``, rn the last (or predicted) residual per lane.
    """
    global refine_sweeps, refine_accurate_sweeps
    tol = NS_TOL
    B, n, _ = A32.shape
    dev = A32.device
    f32 = torch.float32
    eye = torch.eye(n, dtype=f32, device=dev)
    inf = torch.full((B,), float("inf"), dtype=f32, device=dev)
    need = EPS32 * _rnorm(minv) > NS_PROXY_TOL
    rn_cheap = inf
    if host_sync.any_true(need, "linalg.refine_cheap"):
        active = need
        refine_sweeps += 3
        for _ in range(3):
            R = eye - A32 @ minv
            rn = _rnorm(R)
            rn_cheap = torch.where(active, rn, rn_cheap)
            do = active & (rn > tol)
            minv = torch.where(do[:, None, None], minv + minv @ R, minv)
            active = do
        floor_est = (torch.tensor(EPS32, dtype=f32)
                     * torch.sqrt(torch.tensor(float(n), dtype=f32))
                     * _rnorm(minv))
        tol_eff = torch.clamp(4.0 * floor_est, tol, NS_CAP)
        if _gated:
            need = need & (rn_cheap > tol_eff)

    exit_rn = float(torch.tensor((0.3 * tol) ** 0.5, dtype=f32))
    thresh = max(exit_rn, float(torch.tensor(tol, dtype=f32)))
    rn = torch.where(need, inf, torch.zeros_like(inf))
    for _ in range(NS_MAX_SWEEPS):
        active = rn > thresh
        if not host_sync.any_true(active, "linalg.refine_accurate"):
            break
        refine_sweeps += 1
        refine_accurate_sweeps += 1
        R = _residual_f64(A32, minv)
        rn_new = _rnorm(R)
        do = active & (rn_new > tol)
        minv = torch.where(do[:, None, None], minv + minv @ R, minv)
        rn = torch.where(active, rn_new, rn)
    rn = torch.where(rn > tol, torch.minimum(rn, rn * rn), rn)
    return minv, rn


@contextlib.contextmanager
def ungated_refinement():
    """Newton-Schulz without its phase-2 gate while the context is open:
    every lane the proxy selects takes the accurate f64 sweeps, as the
    reference under ``KINETICA_NS_PHASE2=always``.

    The gate trades accuracy for the emulated f64 product on a TPU: a
    factor it passes may keep a residual up to ``NS_CAP``, and the
    "inv"/"inv_gated" solves then take their two refinement sweeps to
    ~NS_CAP^3. The primal's Newton iteration is judged on f64 residuals
    and absorbs that; a forward tangent through the factor (rule 2,
    -M dA M) is judged by nothing. The forward-sensitivity solves run in
    this context (:mod:`kinetica_tpu_torch.solving.sensitivity`).
    """
    global _gated
    saved, _gated = _gated, False
    try:
        yield
    finally:
        _gated = saved


def _inv_factor(A: torch.Tensor, inverse=schur_inverse) -> torch.Tensor:
    """Equilibrate (f32) -> Gauss-Jordan kernel in f64 (block-Schur above
    128 species), rounded to f32 -> Newton-Schulz -> fold scales; rule 2
    on a dual ``A``. ``inverse`` is the f64 inverse of the equilibrated
    matrix (the kernel's; ``schur_inverse_plain`` for comparisons)."""
    if has_tangent(A):
        return _FactorRule.apply(A, inverse)
    return _inv_factor_primal(A, inverse)


class _FactorRule(torch.autograd.Function):
    """Rule 2: the refined f32 factor, the tangent -M dA M."""

    @staticmethod
    def forward(ctx, A, inverse):
        M = _inv_factor_primal(A, inverse)
        ctx.save_for_forward(M)
        return M

    @staticmethod
    def jvp(ctx, dA, _):
        M, = ctx.saved_tensors
        return inverse_tangent(M, dA)


def _inv_factor_primal(A: torch.Tensor, inverse) -> torch.Tensor:
    As, dr, dc = _equilibrate(A)
    minv = inverse(As.double()).to(torch.float32)
    minv, _ = newton_schulz_refine(minv, As)
    return dc[:, :, None] * minv * dr[:, None, :]


def lu_precision_dtype(lu_precision: str, method: str,
                       dtype: torch.dtype) -> torch.dtype:
    """The factor dtype of ``bdf_solve(lu_precision=...)`` for a resolved
    ``method`` and the state ``dtype``: "mixed" is f32, "full" the state
    dtype and only with "lu" (the inverses are f32 only)."""
    if lu_precision == "mixed":
        return torch.float32
    if lu_precision != "full":
        raise ValueError(f"lu_precision must be 'mixed' or 'full', got "
                         f"{lu_precision!r}")
    if method != "lu":
        raise ValueError(f"lu_precision='full' needs linsolve='lu': the "
                         f"{method!r} factor is an f32 inverse")
    return dtype


def newton_factor(J: torch.Tensor, c: torch.Tensor,
                  lu_dtype: torch.dtype = torch.float32,
                  method: str = "inv_gated",
                  need: torch.Tensor | None = None,
                  prev: NewtonFactors | None = None) -> NewtonFactors:
    """Factor A = I - c J for a batch of lanes.

    The parameters are the reference's, in its order; ``prev`` is the
    port's own. ``lu_dtype`` is the factor's precision: the inverse
    methods build an f32 inverse and raise for any other dtype; "lu"
    takes f32 or f64 and builds an f64 LU either way (the reference's CPU
    promotes its mixed-precision LU to the full one). The default
    ``method`` is "inv_gated", where the reference's is "lu": the port's
    accelerator choice.

    ``method`` "inv_gated" (the main path), "inv" or "inv_fused": the
    equilibrated f32 explicit inverse with its scales folded in. With
    ``need`` given, only the lanes whose flag is set are rebuilt; the
    others keep ``prev.lu`` (zeros without ``prev``). A lane's factor
    depends on which other lanes are rebuilt with it only through f32
    rounding: the Newton-Schulz sweeps, and above 128 species the Schur
    coupling products, are cuBLAS GEMMs whose kernel may change with the
    sub-batch size (on an H100 a one-lane f32 GEMM rounded 7.2e-7
    relative away from the batched one). The three methods build the same
    factor. "lu": f64 LU factors of A
    (``torch.linalg``), an explicit cross-check option only.
    """
    global factor_builds, factor_lanes
    B, n, _ = J.shape
    if lu_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lu_dtype must be torch.float32 or torch.float64, "
                         f"got {lu_dtype!r}")
    if method in INV_METHODS:
        if lu_dtype != torch.float32:
            raise ValueError(f"linsolve {method!r} builds an f32 inverse; "
                             f"an {lu_dtype} factor needs method='lu'")
    elif method != "lu":
        raise ValueError(f"unknown linsolve {method!r}")
    with span("linalg.factor") as sp:
        lanes = B
        if method == "lu":
            # every lane is factored; ``need`` picks the ones kept
            A = _newton_matrix(J, c).double()
            lu, piv = torch.linalg.lu_factor(A)
            if need is not None and prev is not None:
                keep = ~need[:, None, None]
                lu = torch.where(keep, prev.lu, lu)
                piv = torch.where(keep[:, :, 0], prev.piv, piv)
        else:
            if need is None:
                lu = _inv_factor(_newton_matrix(J, c))
            else:
                lu = (prev.lu.clone() if prev is not None else
                      torch.zeros(B, n, n, dtype=torch.float32,
                                  device=J.device))
                idx = host_sync.true_indices(need, "linalg.factor_gate")
                lanes = idx.numel()
                if lanes:
                    A = _newton_matrix(J[idx], c[idx])
                    lu.index_copy_(0, idx, _inv_factor(A))
            piv = torch.zeros(B, 0, dtype=torch.int32, device=J.device)
        if lanes:
            factor_builds += 1
            factor_lanes += lanes
        sp.note(lanes=lanes)
    return NewtonFactors(lu=lu, piv=piv, J=J, c=c)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def newton_solve(f: NewtonFactors, b: torch.Tensor, refine: int = 1,
                 method: str = "inv_gated",
                 max_refine: int = MAX_REFINE) -> torch.Tensor:
    """Solve (I - c J) dy = b for (B, n) right-hand sides in the state dtype.

    The parameters are the reference's, in its order (its default
    ``method`` is "lu"; "inv_gated" is the port's accelerator choice).

    "inv_gated" and "inv": dy = M b through the f32 inverse, then exactly
    two refinement sweeps r = b - (dy - c J dy) (the J matvec in J's
    dtype, the residual in b's dtype), dy += M r, whatever ``refine`` and
    ``max_refine`` are: the reference's accelerator schedule
    (``KINETICA_REFINE`` "auto" is "unroll:2" there, which reads neither).
    "inv_fused": one mandatory sweep and then adaptive ones, up to
    ``max_refine`` sweeps in all, in one kernel launch (f32 J); ``refine``
    is not read, as in the reference's kernel call. "lu": one f64 LU
    solve, exact to f64, so no sweep runs (the reference's full-precision
    LU returns there too).
    """
    dtype = b.dtype
    if method == "lu":
        # the f64 factor; an f32 state's b is solved in f64 and cast back
        return torch.linalg.lu_solve(f.lu, f.piv, b.to(f.lu.dtype).unsqueeze(-1)
                                     ).squeeze(-1).to(dtype)
    if method == "inv_fused":
        return fused_newton_solve(f.lu.contiguous(),
                                  f.J.to(torch.float32).contiguous(),
                                  b.contiguous(), f.c.to(dtype).contiguous(),
                                  n_sweeps=max_refine)
    if method not in ("inv", "inv_gated"):
        raise ValueError(f"unknown linsolve {method!r}")

    def solve32(v):
        return _matvec(f.lu, v.to(f.lu.dtype)).to(dtype)

    c = f.c.to(dtype)[:, None]
    dy = solve32(b)
    for _ in range(REFINE_SWEEPS):
        Jdy = _matvec(f.J, dy.to(f.J.dtype)).to(dtype)
        r = b - (dy - c * Jdy)
        dy = dy + solve32(r)
    return dy
