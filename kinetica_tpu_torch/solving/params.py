"""Simulation parameter container with early validation.

Same capability as the reference's ``ODESimulationParams``
(Julia reference src/solving/params.jl:1-110): keyword-constructed, catches
common errors before any expensive work. Field names and defaults match the
reference; ``solver`` selects one of this framework's on-TPU integrators
("bdf" — the default production stiff solver — or "rk45" for non-stiff
systems) instead of a DiffEq solver object.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ODESimulationParams:
    tspan: tuple[float, float]
    u0: object                                  # dict[str, float] | sequence
    solver: str = "bdf"
    jac: bool = True                            # analytic Jacobian (vs autodiff)
    sparse: bool = False                        # dense is the TPU-native choice
    abstol: float = 1.0e-10
    reltol: float = 1.0e-8
    adaptive_tols: bool = True
    update_tols: bool = False
    solve_chunks: bool = True
    solve_chunkstep: float = 1e-3
    maxiters: int = 100000
    ban_negatives: bool = False
    # clamp accepted integrator states onto u >= 0 (tolerance-level
    # projection; trades exact linear-invariant conservation for
    # positivity — negative excursions are explosively unstable under
    # quadratic mass action). Distinct from ban_negatives, which REJECTS
    # offending steps like the reference's isoutofdomain.
    project_negatives: bool = True
    progress: bool = False
    save_interval: float | None = None
    low_k_cutoff: object = "auto"               # float | "auto" | "none"
    low_k_maxconc: float = 2.0
    allow_short_u0: bool = False
    # TPU-specific extensions (no reference equivalent):
    dtype: str = "float64"                      # solve precision policy
    lu_precision: str = "mixed"                 # "mixed" f32-LU+refinement | "full"
    jac_dtype: str = "auto"                     # Newton-Jacobian precision:
    #   "auto" = f32 on accelerators (J is a preconditioner; f64 emulation
    #   is ~12x slower on TPU), f64 on CPU | "float32" | "float64"
    chunks_per_dispatch: int | None = None      # None = auto (all on CPU, 32 on TPU)
    # RHS contraction r @ N implementation: "auto" = the fully-fused
    # Pallas RHS kernel on accelerators (gathers + pair products +
    # sliced-compensated contraction in one launch, f64-accurate without
    # f64 matmuls, ops/pallas_matmul.py), plain dot on CPU; "fused"
    # forces the fused kernel; "dd" the sliced-compensated contraction
    # with the XLA rate pipeline; "float64" the plain dot everywhere.
    rhs_contraction: str = "auto"
    # Newton linear-solve method: "auto" = Pallas explicit inverse with
    # lane-compacted factor refreshes ("inv_gated") on accelerators,
    # LAPACK "lu" on CPU (ops/linalg.resolve_linsolve; r4 measured
    # inv_gated 1.4-1.6x over the ungated "inv" at B=64). "inv" keeps
    # the full-batch factor rebuild; "inv_fused" runs the whole solve
    # (matvec + pair-precision refinement) in one Pallas launch —
    # faster on saturated / ill-conditioned regimes where refinement
    # sweeps run deep, slower on shallow-converging solves.
    linsolve: str = "auto"
    # Relative c = h/alpha drift above which the cached Newton factor is
    # refactored (CVODE's dgmax analogue, and its 0.3 default; stale-c
    # factors self-correct through per-solve refinement). Production
    # sweep at 0.3 vs 0.1: 29.5 -> 26.9 ms/profile with FEWER steps
    # (679 vs 771 max) — at B=64 the any-lane refactor gate fires ~every
    # step regardless, but each lane's factor staying put between its
    # own >30% drifts steadies the controller.
    lu_drift_tol: float = 0.3
    # Newton-matrix policy: "lazy" (default) caches J/LU and refreshes on
    # drift or Newton failure; "always" evaluates J and refactors at every
    # step attempt. Measured (r4 ablation, docs/design.md): "always"
    # loses badly everywhere — 82 vs 31 ms/profile at nc=24, 923 vs 199
    # at nc=60 — because the lane-compacted gated paths (inv_gated
    # factor, compacted jac refresh) stripped the any-lane overhead that
    # once made the lazy gates look ~free to bypass. Keep "lazy".
    jac_policy: str = "lazy"
    # Analytic-Jacobian contraction form: "segsum" (segment-sum over
    # (reaction, slot) pairs — no matmul, best for f64 Jacobians where
    # TPU matmuls are emulated, and on CPU) | "matmul" (arity batched
    # f32 MXU dot_generals — half the operand traffic and no scatter;
    # best for the f32 preconditioner Jacobian on accelerators).
    # "auto" picks matmul exactly when the Jacobian dtype is f32 on a
    # non-CPU backend. Values agree to rounding (tests/test_mass_action).
    jac_form: str = "auto"
    # Concentration floor of the smooth nonnegative clip applied to u
    # before rate evaluation (models.mass_action._clip_pos): species
    # within ~clip_delta of zero see smoothly damped rates (~27% at
    # u = clip_delta, vanishing by ~10x above it). "auto" scales the
    # width with the requested accuracy — min(1e-12, 0.01 * abstol) —
    # so the biased region always sits two decades below what the solve
    # resolves; an explicit float pins it. Note the adaptive-tolerance
    # retry tightens tolerances at run time but keeps the floor chosen
    # from the REQUESTED abstol.
    clip_delta: object = "auto"                 # float | "auto"
    # Carry the BDF method state (difference array, order, equal-step
    # counter) across chunk boundaries so chunkwise solves resume instead
    # of cold-restarting at order 1 — measured ~25-30% fewer steps on the
    # 28-chunk production sweep with the chunked/unchunked gap closing to
    # the stop-clamp cost. The reference's reinit! drops this state at
    # every chunk (methods.jl:819); disable to reproduce that behaviour.
    chunk_warm_start: bool = True

    def __post_init__(self):
        if self.tspan[0] >= self.tspan[1]:
            raise ValueError(
                f"Invalid time span: Start = {self.tspan[0]}, End = {self.tspan[1]}")

        if isinstance(self.low_k_cutoff, str):
            if self.low_k_cutoff not in ("auto", "none"):
                raise ValueError(
                    "low_k_cutoff must be a numerical value or one of ['auto', 'none']")
        elif self.low_k_cutoff < 0:
            raise ValueError(
                "low_k_cutoff must be a positive number or one of ['auto', 'none']")

        if self.solve_chunks:
            n_chunks = self.tspan[1] / self.solve_chunkstep
            if abs(n_chunks - round(n_chunks)) > 1e-9 * max(1.0, abs(n_chunks)):
                raise ValueError(
                    "Simulation timespan is not divisible by requested "
                    "chunkwise simulation step size")

        if (self.solve_chunks and self.save_interval is not None
                and self.save_interval > self.solve_chunkstep):
            raise ValueError(
                "Solution save interval must be less than chunkwise "
                "simulation step size")

        if self.solver not in ("bdf", "rk45"):
            raise ValueError(f"Unknown solver '{self.solver}' (use 'bdf' or 'rk45')")

        if self.chunks_per_dispatch is not None and self.chunks_per_dispatch < 1:
            raise ValueError("chunks_per_dispatch must be a positive integer")

        if self.jac_dtype not in ("auto", "float32", "float64"):
            raise ValueError(
                "jac_dtype must be one of ['auto', 'float32', 'float64']")

        if self.rhs_contraction not in ("auto", "float64", "dd", "fused"):
            raise ValueError("rhs_contraction must be one of "
                             "['auto', 'float64', 'dd', 'fused']")

        if self.linsolve not in ("auto", "lu", "inv", "inv_fused",
                                 "inv_gated"):
            raise ValueError("linsolve must be one of "
                             "['auto', 'lu', 'inv', 'inv_fused', "
                             "'inv_gated']")

        if not (0.0 <= self.lu_drift_tol < 1.0):
            raise ValueError("lu_drift_tol must be in [0, 1)")

        if self.jac_policy not in ("lazy", "always"):
            raise ValueError("jac_policy must be one of ['lazy', 'always']")

        if self.jac_form not in ("auto", "segsum", "matmul"):
            raise ValueError(
                "jac_form must be one of ['auto', 'segsum', 'matmul']")

        if isinstance(self.clip_delta, str):
            if self.clip_delta != "auto":
                raise ValueError("clip_delta must be a positive float or "
                                 "'auto'")
        elif self.clip_delta <= 0:
            raise ValueError("clip_delta must be a positive float or 'auto'")

        # Sparse Newton matrices are a CPU/KLU concept (reference
        # params.jl:55-110); on TPU the dense path IS the fast path (MXU
        # matmuls, Pallas dense inverse) and no sparse factorisation
        # exists. Reject rather than silently ignore.
        if self.sparse:
            raise ValueError(
                "sparse=True is not supported by the TPU-native solver "
                "stack: Newton systems are dense by design (the MXU has no "
                "sparse path and XLA provides no sparse LU). Use the "
                "default sparse=False.")
