"""Smoke run of kinetica_tpu_torch on one NVIDIA GPU.

Builds the port's five CUDA kernels from ``kinetica_tpu_torch/csrc`` (one
``nvcc`` each, all at once), checks each against its plain PyTorch version
at the shapes of the main paths (phase 4f: the multi-tile widths n = 181
and 512, through the block-Schur inverse), then drives five paths through
their public entry points, under 40-60 K/s ramps from 500 K, 28 chunks of
0.5 s. On ``synthetic_pyrolysis_network(24)`` (1095 reactions, 73
species):

* phase 5: the 64-profile continuous-rate sweep of ``bench.py`` through
  ``EnsembleProblem(rate_mode="continuous")`` (fused RHS, ``inv_gated``);
* phase 6: member 0's ramp through ``solve_network`` (chunkwise,
  continuous, ``linsolve="inv_fused"``, ``rhs_contraction="dd"``);
* phase 7: the 64 ramps through the discrete ensemble (rate updates
  every 0.1 s, ``inv_fused`` + ``dd``).

On ``synthetic_pyrolysis_network(60)`` (4473 reactions, 181 species, the
multi-tile width of ``bench.py`` at ``KINETICA_BENCH_NC=60``):

* phase 8: the 64-profile continuous sweep, as phase 5 (the factor
  through the block-Schur inverse);
* phase 9: member 0's ramp through ``solve_network``, as phase 6.

The solves built on the BDF core, on the nc=24 network (static
temperatures, 1e-8 / 1e-10) unless stated:

* phase 10: ``find_steady_state_ensemble`` over 64 temperatures from 700
  to 950 K (fused RHS, ``inv_gated``), lanes 0, 32 and 63 against
  scipy-BDF over the same epochs; ``find_steady_state`` for member 0; and
  ``steady_state_sensitivities`` of a reversible isomerisation against
  its closed form;
* phase 11: ``solve_adjoint_gradient`` of u_C1 at 0.05 s and 650 K,
  against the same call on the CPU (the kernels' plain versions) and the
  top three reactions against central differences of scipy-BDF; the
  Gauss-Jordan kernel builds the factors of the forward and the backward
  solve;
* phase 12: ``solve_network(solver="rk45")`` on a 3-species chain against
  the port's BDF solve (the fused RHS in every stage), and 64 van der Pol
  lanes of ``rk45_solve`` against scipy's RK45;
* phase 13: phase 7's discrete ensemble and member 0 with
  ``dtype="float32"`` (the Gauss-Jordan kernel, the plain f32 dot),
  against phase 7's f64 result.

Forward sensitivities and the analysis layer, on the nc=24 network:

* phase 4g: the kernels' forward-mode rules (the JAX package's
  ``custom_jvp`` rules) on the card: the tangent through each kernel
  against the same rule through its plain version, the Newton solve's
  extra tangent launch, and a dual input into the fused RHS raising;
* phase 14a: ``SensitivityProblem`` at phase 11's problem with all 1095
  reactions as tangent lanes, w @ S[-1] against phase 11's adjoint
  gradient; phase 14b: 64 rids on the 700 -> 1100 K ramp of
  ``tests/test_sensitivity.py``, u against scipy-BDF and S against
  central differences of the same solve;
* phase 15: Morris (B=512) and Sobol (B=640) on the discrete ensemble at
  phase 11's problem, design points against scipy-BDF;
* phase 16: DRG and DRGEP reductions, reaction fluxes and the
  save/load round trip on phase 6's ramp cut to 2 s; each ladder held to
  the same ladder on the CPU from the card's trajectory.

The chemistry layer, the calculators and exploration:

* phase 17: BASELINE config 5, the kinetics-gated iterative exploration
  of ``scripts/bench_explore.py 64`` (4 levels from CC over the native
  ``cde_lite`` sampler, each gated by the 64-ramp discrete ensemble):
  the species/reactions of each level against the JAX package's record,
  members 0 and 63 of every gate against scipy-BDF (in a process pool
  beside phases 18-20), the seeds against those
  references, the fused RHS and Gauss-Jordan kernels against their plain
  versions at each gate's shapes, the checkpoint loading back, the native
  chem library and ``cde_lite`` built under ``kinetica_tpu_torch/_build``;
* phase 18: the KPM calculators on phase 17's final network, card
  against CPU, and a 64-ramp continuous sweep with the collision
  calculator against scipy-BDF; the fake-ASE ``ASENEBCalculator`` on
  CC <-> C=C + H2 and a ``TSTCalculator`` at the nc=24 width, card
  against CPU.

The sharded ensemble and profiling:

* phase 19: ``EnsembleProblem`` over a process mesh of four gloo ranks
  sharing the card (``kinetica_tpu_torch.testing.sharded_ranks``), 8 of
  phase 5's ramps at nc=24, each over the first 1 s: 19a a (batch=2,
  model=2) mesh in phase 5's continuous configuration (each model rank 548
  of the 1096 padded reactions, the fused RHS on its block), 19b the same
  mesh in phase 7's discrete one (``inv_fused`` + ``dd``), 19c a (4,)
  batch mesh; every rank's solution bit-equal to every other's, within
  1e-8 mole fraction of the unsharded solve of the same members (19c: its
  last block within the batch axis's rtol 1e-6 / atol 1e-12 of that
  block's unsharded solve), member 0 within 1e-6 of scipy-BDF, each rank's
  block kernels against their plain versions and launched in every rank;
* phase 20: ``utils.profiling.trace`` around phase 6's ``solve_network``
  cut to one chunk with an ``annotate`` span (the Chrome trace must hold
  the span, the kernels' device events and the program's ``bdf.step`` and
  ``host_sync.read`` spans; the solve record's spans must start within 50
  us of their twins in the trace, and every kernel inside the record's
  outermost span), ``Timings`` with the reference's three sections.

The user programs:

* phase 21: the examples (``kinetica_tpu_torch.examples``) through their
  ``main`` at the JAX examples' published sizes, on the card:
  ``getting_started`` (the explored network equal to the JAX package's
  record, the final state against scipy-BDF, ``results.npz`` loading
  back), ``pyrolysis_sweep`` (members 0 and 31 of the timed second solve
  against scipy-BDF), ``analysis_pipeline`` (the Morris top 8, the Sobol
  indices, the DRGEP kept reactions and the projected flux's top 4
  channels against the port's CPU run of the same call, in the worker
  pool), ``iterative_exploration`` and ``full_product`` (the species and
  reactions by level equal to the JAX package's records, member 0 of the
  last gate against scipy-BDF; ``full_product``'s DRGEP stage raises the
  JAX package's own ``ValueError`` at its published settings, or meets
  its tolerance);
* phase 22: every Python block of ``docs/tutorials/*.md`` on the card
  (``kinetica_tpu_torch.testing.tutorials``), the package name the only
  change; the blocks that need matplotlib are named as not run where it
  is not installed.

The measurement programs (``kinetica_tpu_torch.scripts``), once every
other phase and process has ended, so each runs alone on the card, one
after another in a worker process, each through its ``main``:

* phase 23a: ``bench --repeats 3`` at its defaults (nc=24, B=64): its one
  JSON line, member 0 within 1e-6 of scipy-BDF, the card's name and power
  limit beside the times;
* phase 23b: ``bench_longhorizon``, the 1e5 s horizon in its 40 chunks,
  cut (time budget) from B=64 to 8: member 0 within 1e-6 of the chunked
  scipy-BDF, the carbon drift within 1e-6, the steps max within 1.2x the
  JAX package's 2909 on the TPU;
* phase 23c: ``step_count_audit`` at its three lanes (40, 50, 60 K/s),
  the card's accepted steps beside scipy-BDF's.

Once the kernels are timed (phases 2-4g), three processes of their own
share the card with the main one: phase 21's examples in two, phase 22
in a third and phases 11 and 14-16 in a fourth; they run beside phases
5-20 and report their lines and launches at the end. Each process's CPU
references run in a worker pool of its own beside its card work; phase
17's are checked after phase 20. Phase 20 runs last in its process: in a
process that has run a ``torch.profiler`` session launches cost more.
Every process this script starts dies with it, and a failure or a
SIGTERM kills them first.

Each path is held against a pure-numpy scipy-BDF reference (or the
reference named above), and every kernel of a path must have launched
during that path's run (the counts are set to 0, and the once-per-process
grid probe re-armed, just before it).

Phases 3-4 also hold the kernels on their edge cases
(``kinetica_tpu_torch.testing.kernel_cases``: Gauss-Jordan at n = 1, 33,
53, 73, 127, 128 with a pivot tie, a NaN column, a singular and a
near-singular member, and on near-singular Newton matrices at n = 19, 73,
128 and, through the block-Schur inverse, 181, every entry equal to the
plain version's, in f64 (the Newton factor's elimination, the kernels
line's ``gj_inverse``) and in f32 (``gj_inverse_f32``, off the main path:
the witness that the elimination is the JAX kernel's);
the fused RHS at B = 1 and 64 on a network with an empty and a 700-entry
species row; the Newton solve at n = 1, 31, 32, 33, 73, 181 with b = 0, a
NaN lane and a stale lane, at B = 4, 1 and 0, and at every cluster size
the card takes, bit for bit equal to the planned one), and time every
kernel three ways
(``kinetica_tpu_torch.testing.device_timing``): ``ms`` (one call between
CUDA events, host work included), ``graph_ms`` (device only: 20 calls in
one CUDA graph, replayed) and ``library_ms`` (the one PyTorch call that
computes the same function, where there is one: timed as ``graph_ms``,
or over 20 calls back to back where a graph cannot capture it), beside
``bound_ms`` (the bytes or the operations of the work at the H100's
peak rates); the Newton solve also at B = 1, the single solve's shape.
The ``kernels`` line also gives each kernel's launches per step on each
path (phases 5-22; per rank on 19a-19c), its forward-mode rule with phase
4g's check, the Newton solve's tangent launches in phase 4g and its device
ms per step on phases 6, 7 and 9.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA GPU. Exits non-zero, printing no result line, when there is
no GPU, when the package is not next to this script, or when any phase
fails. The last line of standard output is the JSON result.
"""
import contextlib
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_CARBONS, BATCH, TF, CHUNK, TS_UPDATE = 24, 64, 14.0, 0.5, 0.1
WIDE_CARBONS, WIDE_N = 60, 512      # the multi-tile network; the widest inverse
RTOL, ATOL, K_MAX = 1e-8, 1e-10, 1e12
# scipy-BDF's tolerances where it is the reference of phases 14-15: at
# RTOL / ATOL its static 650 K solve is 3.2e-6 mole fraction off its
# own converged value on the nc=24 network (and slower)
REF_RTOL, REF_ATOL = 1e-10, 1e-16
KERNELS = ("fused_rhs", "gj_inverse", "dd_contract", "newton_solve",
           "grid_probe")
# the yardstick of the inverses: a CUDA graph cannot capture it (it
# synchronises inside), so it is timed over 20 calls back to back
LIBRARY_INV = "torch.linalg.inv_ex, loop_ms"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    kill_children()
    sys.exit(1)


def kill_children() -> None:
    """Kill and reap every process this one started (pool workers, ranks);
    theirs die with them (``die_with_parent``)."""
    for p in multiprocessing.active_children():
        p.kill()
    for p in multiprocessing.active_children():
        p.join(10)


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker and reap it: started with
    this process's first pool, it would otherwise outlive this process as
    an orphan. Registrations after this are dropped (their semaphores are
    still unlinked by their finalizers)."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    fd, pid = tracker._fd, tracker._pid
    tracker.ensure_running = tracker._send = lambda *args: None
    if fd is None or pid is None:
        return
    tracker._fd = tracker._pid = None
    os.close(fd)      # the tracker ends when its last writer closes
    deadline = time.monotonic() + 10.0
    while not os.waitpid(pid, os.WNOHANG)[0]:
        if time.monotonic() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            return
        time.sleep(0.05)


def _worker_init() -> None:
    """A pool worker: dies with the process that started it, and takes two
    of the host's cores for its CPU work."""
    import torch
    from kinetica_tpu_torch.testing.sharded_ranks import die_with_parent
    die_with_parent()
    torch.set_num_threads(2)


def spawn_pool(n: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
        "spawn"), initializer=_worker_init)


def say(msg: str) -> None:
    print(msg, flush=True)


def import_port():
    sys.path.insert(0, HERE)
    try:
        import kinetica_tpu_torch
    except ImportError as exc:
        fail(f"kinetica_tpu_torch not importable next to {HERE}: {exc}")
    pkg_dir = os.path.dirname(os.path.abspath(kinetica_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"kinetica_tpu_torch found at {pkg_dir}, not next to this script")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")


def build_problem(device, ts_update=None, n_carbons=N_CARBONS, batch=BATCH,
                  tf=TF, **par_kw):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

    sd, rd, Ea, A = synthetic_pyrolysis_network(n_carbons)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=device)
    conditions = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=500.0, X_end=500.0 + float(r) * tf)},
        ts_update=ts_update)
        for r in np.linspace(40.0, 60.0, batch)]
    kw = dict(linsolve="auto", rhs_contraction="auto")
    kw.update(par_kw)
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{n_carbons}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
        jac_policy="lazy", lu_drift_tol=0.3, **kw)
    return sd, rd, calc, conditions, pars


class Counts:
    """The launch and host-sync counters of one path's run."""

    def __init__(self):
        from kinetica_tpu_torch.ops import (bdf, dd_contract, fused_rhs,
                                            gj_inverse, grid_probe, host_sync,
                                            newton_solve)
        self.mods = dict(fused_rhs=fused_rhs, gj_inverse=gj_inverse,
                         dd_contract=dd_contract, newton_solve=newton_solve,
                         grid_probe=grid_probe)
        self.host_sync = host_sync
        self.bdf = bdf

    def reset(self):
        """Counts to 0, and the grid probe re-armed so the path runs it."""
        for mod in self.mods.values():
            mod.launches = 0
        self.mods["grid_probe"].passed = False
        self.host_sync.count = 0
        self.bdf.jac_refreshes = 0

    def read(self):
        return ({k: m.launches for k, m in self.mods.items()},
                self.host_sync.count)


def require_launched(phase, launches, names):
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        fail(f"phase {phase}: kernel(s) {missing} not launched during the "
             f"path's run: {launches}")


def final_err(u, ref):
    return float(np.max(np.abs(u - ref) / max(ref.sum(), 1.0)))


def trajectory_err(u, ref):
    """``final_err`` at every save point of every member: (B, n_t, ns)."""
    total = np.maximum(ref.sum(axis=-1, keepdims=True), 1.0)
    return float(np.max(np.abs(u - ref) / total))


def static_method(device, T, tf=1.0):
    """A StaticODESolve of the phase-5 network at ``T`` from C24 alone."""
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.solving.methods import StaticODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

    sd, rd, Ea, A = synthetic_pyrolysis_network(N_CARBONS)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=device)
    pars = ODESimulationParams(tspan=(0.0, tf), u0={f"C{N_CARBONS}": 1.0},
                               low_k_cutoff="none", abstol=ATOL, reltol=RTOL)
    return StaticODESolve(pars, ConditionSet({"T": float(T)}), calc), sd, rd


def timed_run(fn):
    """``fn()`` between two device synchronisations -> (result, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_steady_state(dev, counts, record):
    """Phase 10: steady states of 64 static temperatures in one batched
    pseudo-transient continuation; three lanes against scipy-BDF of the
    same ODE (rates on the smooth nonnegative part of u) over the same
    epochs; member 0 alone; the sensitivities of an interior equilibrium
    against their closed form."""
    from kinetica_tpu_torch import constants
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    from kinetica_tpu_torch.models.mass_action import resolve_clip_delta
    from kinetica_tpu_torch.solving.methods import StaticODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.solving.steady_state import (
        find_steady_state, find_steady_state_ensemble,
        steady_state_sensitivities)
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_static

    temps = np.linspace(700.0, 950.0, BATCH)
    method, sd, rd = static_method(dev, temps[0])
    conds = [ConditionSet({"T": float(T)}) for T in temps]
    counts.reset()
    ens, wall = timed_run(lambda: find_steady_state_ensemble(
        method, sd, rd, conds, device=dev))
    launches, syncs = counts.read()
    if not ens.success:
        fail(f"phase 10: lanes not converged: {np.flatnonzero(~ens.converged)}")
    if ens.u.shape != (BATCH, sd.n) or not np.all(np.isfinite(ens.u)):
        fail(f"phase 10: bad steady states {ens.u.shape}")
    require_launched(10, launches, ("fused_rhs", "gj_inverse", "grid_probe"))
    horizons = [10.0 ** e for e in range(ens.epochs)]     # t_first 1, x10
    if abs(sum(horizons) - ens.t_total) > 1e-9 * ens.t_total:
        fail(f"phase 10: epochs {ens.epochs} do not add up to {ens.t_total}")
    steps = ens.n_steps.max(axis=1)                     # slowest lane, epoch
    u0 = make_u0(sd, method.pars)
    delta = resolve_clip_delta(method.pars)
    errs = {}
    t0 = time.perf_counter()
    for b in (0, BATCH // 2, BATCH - 1):
        k = method.calculator(float(temps[b])).cpu().numpy()
        u = u0
        for T in horizons:
            u = scipy_bdf_static(sd, rd, k, T, u, RTOL, ATOL, delta)
        errs[b] = final_err(ens.u[b], u)
    ref_s = time.perf_counter() - t0
    if max(errs.values()) > 1e-6:
        fail(f"phase 10: lanes differ from scipy-BDF: {errs} (> 1e-6)")
    single, single_s = timed_run(lambda: find_steady_state(
        method, sd, rd, device=dev))
    err_single = final_err(single.u, ens.u[0])
    if not single.converged or err_single > 1e-6:
        fail(f"phase 10: find_steady_state member 0: converged "
             f"{single.converged}, vs ensemble lane 0 {err_single:.3e}")
    # A <=> B at k_f = 3 k_r: du*_B / d ln k_f = k_f k_r / (k_f + k_r)^2
    sdi = SpeciesData(["C=CC=C", "C#CCC"])
    rdi = RxData.from_reactions(sdi, [["C=CC=C"], ["C#CCC"]],
                                [["C#CCC"], ["C=CC=C"]])
    calci = PrecalculatedArrheniusCalculator(
        np.zeros(2), np.array([3.0, 1.0]) / constants.N_A, device=dev)
    parsi = ODESimulationParams(tspan=(0.0, 1.0), u0={"C=CC=C": 1.0},
                                low_k_cutoff="none")
    S = steady_state_sensitivities(
        StaticODESolve(parsi, ConditionSet({"T": 500.0}), calci), sdi, rdi,
        device=dev)
    err_S = abs(S[sdi.toInt["C#CCC"], 0] / (3.0 / 16.0) - 1.0)
    if not err_S <= 1e-6:
        fail(f"phase 10: isomerisation sensitivity off its closed form by "
             f"{err_S:.3e} (relative)")
    total = int(steps.sum())
    say(f"phase 10 steady-state ensemble: {rd.nr} rxn / {sd.n} sp, B={BATCH} "
        f"static T {temps[0]:.0f}-{temps[-1]:.0f} K: all converged in "
        f"{ens.epochs} epochs (t_total {ens.t_total:.6g} s); steps per epoch "
        f"(slowest lane) {steps.tolist()}, {total} in all; {wall:.3f} s "
        f"({wall * 1e3 / total:.3f} ms/step); host syncs {syncs} "
        f"({syncs / total:.2f}/step); max residual {ens.residual.max():.3e};"
        f" lanes {list(errs)} vs scipy-BDF over the same epochs max "
        f"mole-fraction err {max(errs.values()):.3e} (scipy {ref_s:.3f} s on "
        f"this host); find_steady_state member 0: {single.epochs} epochs, "
        f"{single_s:.3f} s, vs lane 0 {err_single:.3e}; isomerisation "
        f"du*_B/d ln k_f {S[sdi.toInt['C#CCC'], 0]:.12f} (3/16, rel err "
        f"{err_S:.2e}); launches {launches} "
        f"({sum(launches.values()) / total:.2f} of these kernels/step)")
    record("10", launches, total)


# the JAX package's solve_adjoint_gradient on phase 11's problem, on a CPU
# (its 257-node storage grid): g and the top-5 reactions by |grad|
JAX_ADJOINT = (1.1205e-6, [872, 0, 145, 144, 926])


ADJOINT_T, ADJOINT_TF = 650.0, 0.05


def _adjoint_weights(sd):
    w = np.zeros(sd.n)
    w[sd.toInt["C1"]] = 1.0
    return w


def _adjoint_reference(_):
    """Phase 11's gradient with the plain versions on the CPU, and central
    differences of scipy-BDF for its three largest entries (a worker's
    job, run beside phase 11 on the card)."""
    import torch
    from kinetica_tpu_torch.models.mass_action import resolve_clip_delta
    from kinetica_tpu_torch.solving import adjoint
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_static

    torch.set_num_threads(2)
    method, sd, rd = static_method("cpu", ADJOINT_T, ADJOINT_TF)
    w = _adjoint_weights(sd)
    t0 = time.perf_counter()
    grad, g = adjoint.solve_adjoint_gradient(method, sd, rd, w, n_nodes=257,
                                             device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_steps = (adjoint.last_stats["forward"]["n_steps"],
                 adjoint.last_stats["backward"]["n_steps"])
    k = method.calculator(ADJOINT_T).numpy()
    u0 = make_u0(sd, method.pars)
    fd = {}
    t0 = time.perf_counter()
    for j in [int(j) for j in np.argsort(-np.abs(grad))[:3]]:
        gs = []
        for sign in (1.0, -1.0):
            kj = k.copy()
            kj[j] *= np.exp(sign * 1e-3)
            gs.append(float(w @ scipy_bdf_static(
                sd, rd, kj, ADJOINT_TF, u0, 1e-10, 1e-20,
                resolve_clip_delta(method.pars))))
        fd[j] = (gs[0] - gs[1]) / 2e-3
    return grad, g, fd, cpu_s, time.perf_counter() - t0, cpu_steps


def phase_adjoint(dev, counts, record, reference):
    """Phase 11: the adjoint gradient of u_C1(0.05 s) at 650 K w.r.t. every
    ln k, on the card and with the plain versions on the CPU (the future
    ``reference`` of :func:`_adjoint_reference`); the top three against
    central differences of scipy-BDF."""
    from kinetica_tpu_torch.solving import adjoint

    T, tf = ADJOINT_T, ADJOINT_TF
    method, sd, rd = static_method(dev, T, tf)
    w = _adjoint_weights(sd)
    counts.reset()
    (grad, g), wall = timed_run(lambda: adjoint.solve_adjoint_gradient(
        method, sd, rd, w, n_nodes=257, device=dev))
    launches, syncs = counts.read()
    fwd, bwd = adjoint.last_stats["forward"], adjoint.last_stats["backward"]
    require_launched(11, launches, ("fused_rhs", "gj_inverse", "grid_probe"))
    # one Gauss-Jordan launch a factor (n <= 128): the backward solve's
    # factors went through the kernel too
    if not (bwd["n_lu"] > 0
            and launches["gj_inverse"] == fwd["n_lu"] + bwd["n_lu"]):
        fail(f"phase 11: gj_inverse launches {launches['gj_inverse']}, "
             f"factors forward {fwd['n_lu']} backward {bwd['n_lu']}")
    if grad.shape != (rd.nr,) or not np.all(np.isfinite(grad)):
        fail(f"phase 11: bad gradient {grad.shape}")
    t0 = time.perf_counter()
    grad_c, g_c, fd, cpu_s, fd_s, cpu_steps = reference.result()
    wait_s = time.perf_counter() - t0
    scale = float(np.abs(grad_c).max())
    d = float(np.abs(grad - grad_c).max())
    top = [int(j) for j in np.argsort(-np.abs(grad))[:5]]
    top_c = [int(j) for j in np.argsort(-np.abs(grad_c))[:5]]
    if not (d <= 1e-3 * scale and top == top_c
            and abs(g - g_c) <= 1e-6 * abs(g_c)):
        fail(f"phase 11: card vs CPU: max |d grad| {d:.3e} (max |grad| "
             f"{scale:.3e}), top-5 {top} vs {top_c}, g {g:.10e} vs {g_c:.10e}")
    fd_rel = {j: abs(grad[j] - v) / abs(v) for j, v in fd.items()}
    if max(fd_rel.values()) > 0.05:
        fail(f"phase 11: gradient vs central differences {fd_rel} (> 5%)")
    steps = fwd["n_steps"] + bwd["n_steps"]
    say(f"phase 11 adjoint: {rd.nr} rxn / {sd.n} sp, static {T:.0f} K, tf "
        f"{tf} s, d u_C1(tf) / d ln k: g {g:.10e} (JAX package on a CPU "
        f"{JAX_ADJOINT[0]:.4e}), max |grad| {scale:.4e}, top-5 {top} (JAX "
        f"{JAX_ADJOINT[1]}); card vs CPU (plain versions) max |d grad| "
        f"{d:.3e} (<= 1e-3 max |grad|), same top-5, |d g| / g "
        f"{abs(g - g_c) / abs(g_c):.2e}; top 3 vs central differences "
        f"(scipy-BDF rtol 1e-10, 1e-3 in ln k) "
        + ", ".join(f"{j}: {grad[j]:.5e} vs {fd[j]:.5e} ({fd_rel[j]:.2e})"
                    for j in fd)
        + f" (<= 5%); steps forward {fwd['n_steps']} backward "
        f"{bwd['n_steps']} (factors {fwd['n_lu']} / {bwd['n_lu']}, J "
        f"evaluations {fwd['n_jev']} / {bwd['n_jev']}; the CPU run "
        f"{cpu_steps[0]} / {cpu_steps[1]}); {wall:.3f} s "
        f"({wall * 1e3 / steps:.3f} ms/step), CPU run {cpu_s:.3f} s, "
        f"differences {fd_s:.3f} s on this host in a worker beside phase "
        f"11 (waited {wait_s:.3f} s); host syncs {syncs} "
        f"({syncs / steps:.2f}/step); launches {launches} "
        f"({sum(launches.values()) / steps:.2f} of these kernels/step)")
    record("11", launches, steps)
    return grad


def phase_rk45(dev, counts, record):
    """Phase 12: solve_network with the RK45 solver on the 3-species chain
    against the port's BDF solve, and 64 van der Pol lanes of rk45_solve
    against scipy's RK45."""
    import torch
    from scipy.integrate import solve_ivp
    from kinetica_tpu_torch.calculators.builtin import DummyKineticCalculator
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    from kinetica_tpu_torch.ops.rk45 import DONE, rk45_solve
    from kinetica_tpu_torch.solving.methods import StaticODESolve, solve_network
    from kinetica_tpu_torch.solving.params import ODESimulationParams

    def chain(solver):
        sd = SpeciesData(["A", "B", "C"])
        rd = RxData.from_reactions(sd, [["A"], ["B"], ["B", "B"]],
                                   [["B"], ["A"], ["C"]])
        pars = ODESimulationParams(
            tspan=(0.0, 10.0), u0={"A": 1.0}, solver=solver,
            solve_chunks=True, solve_chunkstep=1.0, reltol=1e-9,
            abstol=1e-12, low_k_cutoff="none")
        calc = DummyKineticCalculator(np.array([1.0, 0.5, 0.3]), device=dev)
        return solve_network(StaticODESolve(pars, ConditionSet({"T": 300.0}),
                                            calc), sd, rd, device=dev).sol

    counts.reset()
    sol, wall = timed_run(lambda: chain("rk45"))
    launches, syncs = counts.read()
    ref = chain("bdf")
    if not (sol.success and ref.success) or sol.u.shape != ref.u.shape:
        fail(f"phase 12: rk45 {sol.retcode}, bdf {ref.retcode}")
    err = float(np.abs(sol.u - ref.u).max())
    if err > 1e-7:
        fail(f"phase 12: rk45 vs bdf max |d u| {err:.3e} (> 1e-7)")
    st = sol.stats
    require_launched(12, launches, ("fused_rhs", "grid_probe"))
    # one RHS a chunk's start and six a step: every stage ran the kernel
    if (launches["fused_rhs"] != st["n_chunks"] + 6 * st["n_steps"]
            or launches["gj_inverse"]):
        fail(f"phase 12: launches {launches} for {st['n_steps']} steps in "
             f"{st['n_chunks']} chunks")

    def vdp(t, y):
        return torch.stack([y[:, 1], (1 - y[:, 0] ** 2) * y[:, 1] - y[:, 0]], 1)

    rng = np.random.default_rng(12)
    y0s = rng.uniform(-2.0, 2.0, (BATCH, 2))
    y0s[0] = (2.0, 0.0)
    sv = np.linspace(0.5, 10.0, 20)
    res, vdp_s = timed_run(lambda: rk45_solve(
        vdp, torch.as_tensor(y0s, device=dev), 0.0, 10.0, sv, rtol=1e-9,
        atol=1e-12))
    ys = res.ys.cpu().numpy()
    worst = 0.0
    for b in range(BATCH):
        sp = solve_ivp(lambda t, y: [y[1], (1 - y[0] ** 2) * y[1] - y[0]],
                       (0.0, 10.0), y0s[b], rtol=1e-11, atol=1e-13,
                       t_eval=sv, method="RK45")
        # the assert_allclose criterion |d| <= atol + rtol |ref|, as a ratio
        worst = max(worst, float((np.abs(ys[b] - sp.y.T)
                                  / (1e-7 + 1e-5 * np.abs(sp.y.T))).max()))
    if not (bool((res.status == DONE).all()) and worst <= 1.0):
        fail(f"phase 12: van der Pol lanes: status {res.status.tolist()}, "
             f"worst |d| / (1e-7 + 1e-5 |ref|) {worst:.3e}")
    n_vdp = res.n_steps.cpu().numpy()
    say(f"phase 12 rk45: chain A <=> B, 2B -> C through solve_network "
        f"(chunkwise {st['n_chunks']} x 1 s, rtol 1e-9): DONE; vs the port's "
        f"bdf max |d u| {err:.3e} (<= 1e-7); steps {st['n_steps']} (accepted "
        f"{st['n_accepted']}, rejected {st['n_rejected']}); {wall:.3f} s "
        f"({wall * 1e3 / st['n_steps']:.3f} ms/step); host syncs {syncs}; "
        f"launches {launches} (the RHS kernel {launches['fused_rhs']} = "
        f"{st['n_chunks']} + 6 x {st['n_steps']}) | rk45_solve B={BATCH} van "
        f"der Pol lanes: all DONE, worst |d| / (1e-7 + 1e-5 |scipy|) "
        f"{worst:.3f} (<= 1); steps max/median {int(n_vdp.max())}/"
        f"{int(np.median(n_vdp))}; {vdp_s:.3f} s")
    record("12", launches, st["n_steps"])


def phase_float32(dev, counts, record, ens7, pars7, conds7, calc7, sd7, rd7):
    """Phase 13: phase 7's discrete ensemble and its member 0 with an f32
    state (abstol 1e-6, reltol 1e-4), against phase 7's f64 result."""
    import dataclasses
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)

    pars = dataclasses.replace(pars7, dtype="float32", abstol=1e-6,
                               reltol=1e-4, linsolve="auto",
                               rhs_contraction="auto")
    counts.reset()
    ens, wall = timed_run(lambda: EnsembleProblem(
        VariableODESolve(pars, conds7[0], calc7), sd7, rd7, device=dev).solve(
            conditions_list=conds7))
    launches, syncs = counts.read()
    if not ens.success:
        fail(f"phase 13: not every lane DONE: {ens.retcodes}")
    if ens.u.shape != ens7.u.shape or not np.all(np.isfinite(ens.u)):
        fail(f"phase 13: bad solution array {ens.u.shape}")
    drift = trajectory_err(ens.u, ens7.u)
    drift_abs = float(np.abs(ens.u - ens7.u).max())
    if drift > 5e-5:
        fail(f"phase 13: f32 ensemble vs f64 phase 7 max mole-fraction err "
             f"{drift:.3e} (> 5e-5)")
    require_launched(13, launches, ("gj_inverse",))
    if launches["fused_rhs"] or launches["dd_contract"] or launches["newton_solve"]:
        fail(f"phase 13: an f64 kernel ran on the f32 path: {launches}")
    steps = np.asarray(ens.stats["n_steps"])
    s_max, s_med = int(steps.max()), int(np.median(steps))
    out, single_s = timed_run(lambda: solve_network(
        VariableODESolve(pars, conds7[0], calc7), sd7, rd7, device=dev))
    sol = out.sol
    drift0 = trajectory_err(sol.u, ens7.u[0]) if sol.success else np.inf
    if not (sol.success and sol.u.dtype == np.float32) or drift0 > 5e-5:
        fail(f"phase 13: solve_network f32 {sol.retcode}, dtype "
             f"{sol.u.dtype}, vs phase 7 member 0 {drift0:.3e} (> 5e-5)")
    say(f"phase 13 float32 state: phase 7's discrete ensemble, B={BATCH}, "
        f"abstol 1e-6 reltol 1e-4, inv_gated + the plain f32 dot: all DONE; "
        f"vs phase 7 (f64) max mole-fraction err {drift:.3e} over every "
        f"member and save point (<= 5e-5; max |d u| {drift_abs:.3e}); "
        f"{wall:.3f} s ({wall * 1e3 / s_max:.3f} ms/step); "
        f"steps max/median {s_max}/{s_med}; host syncs {syncs} "
        f"({syncs / s_max:.2f}/step); launches {launches} | solve_network "
        f"member 0 f32: {sol.stats['n_steps']} steps, {single_s:.3f} s, vs "
        f"phase 7 member 0 max mole-fraction err {drift0:.3e} (<= 5e-5)")
    record("13", launches, s_max)


def _tangent(fn, primals, tangents):
    """``fn`` on forward-mode duals -> (primal, tangent) of its result."""
    from torch.autograd import forward_ad as fwAD
    with fwAD.dual_level():
        duals = [p if t is None else fwAD.make_dual(p, t)
                 for p, t in zip(primals, tangents)]
        return fwAD.unpack_dual(fn(*duals))


def _lane_rel(a, b):
    """Per-lane max |a - b| / max |b|, the largest over the lanes."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return float(((a - b).abs().amax(dim=1)
                  / b.abs().amax(dim=1).clamp_min(1e-300)).max())


def phase_rules(dev, kernels, rng, inputs):
    """Phase 4g: each kernel's forward-mode rule on the card (the tangent
    through the kernel) against the same rule through the plain version,
    on phase 4's, 4c's, 4d's and 4f's inputs with seeded tangents; a dual
    input into the fused RHS must raise."""
    import torch
    from torch.autograd import forward_ad as fwAD
    from kinetica_tpu_torch.ops import gj_inverse, linalg, newton_solve
    from kinetica_tpu_torch.ops.newton_solve import (fused_newton_solve,
                                                     fused_newton_solve_plain)

    def randn(like):
        return torch.as_tensor(rng.standard_normal(tuple(like.shape)),
                               device=dev).to(like.dtype)

    out = {}
    # rules 1 and 2: (tangent kernel vs plain, vs -M dA M in f64, launches)
    cases = (("gj_n73", inputs["As"], gj_inverse.gj_inverse,
              gj_inverse.gj_inverse_plain),
             ("schur_n181", inputs["As181"], gj_inverse.schur_inverse,
              gj_inverse.schur_inverse_plain),
             ("factor_n73", inputs["A4"], linalg._inv_factor,
              lambda a: linalg._inv_factor(a, gj_inverse.schur_inverse_plain)))
    for key, A, fn, plain in cases:
        dA = randn(A)
        n0 = gj_inverse.launches
        M, t_k = _tangent(fn, [A], [dA])
        torch.cuda.synchronize()
        launched = gj_inverse.launches - n0
        _, t_p = _tangent(plain, [A], [dA])
        ref = -(M.double() @ dA.double() @ M.double())
        out[key] = (_lane_rel(t_k, t_p), _lane_rel(t_k, ref), launched)
    # rule 3: the Newton solve, B=64 and B=1: one more launch for the tangent
    M4, JB, b4, c = inputs["newton"]
    tans = [randn(M4), randn(JB), randn(b4), 0.01 * c * randn(c)]
    tangent_launches = {}
    for B in (M4.shape[0], 1):
        prim = [x[-B:].contiguous() for x in (M4, JB, b4, c)]
        tan = [x[-B:].contiguous() for x in tans]
        n0 = newton_solve.launches
        _, t_k = _tangent(fused_newton_solve, prim, tan)
        torch.cuda.synchronize()
        tangent_launches[f"b{B}"] = newton_solve.launches - n0 - 1
        _, t_p = _tangent(fused_newton_solve_plain, prim, tan)
        out[f"newton_b{B}"] = (_lane_rel(t_k, t_p), None,
                               tangent_launches[f"b{B}"])
    # rule 4: the contraction; its tangent is the dense f64 dr @ N
    dd, r_c = inputs["dd"]
    dr = r_c * randn(r_c)
    _, t_k = _tangent(dd, [r_c], [dr])
    _, t_p = _tangent(dd.plain, [r_c], [dr])
    out["dd"] = (float((t_k - t_p).abs().max()),
                 float((t_k - dr @ dd.N).abs().max()), None)
    # a dual tensor into the fused RHS (no rule) raises
    fused, u_aug, k = inputs["fused"]
    raised = False
    try:
        with fwAD.dual_level():
            fused(u_aug, fwAD.make_dual(k, torch.ones_like(k)))
    except RuntimeError as exc:
        raised = "fused_rhs" in str(exc)
    bad = {kk: v for kk, v in out.items()
           if not (v[0] <= (0.0 if kk == "dd" else 1e-5)
                   and (v[1] is None or v[1] <= (0.0 if kk == "dd" else 1e-3)))}
    Bn = M4.shape[0]
    if (bad or not raised or tangent_launches != {f"b{Bn}": 1, "b1": 1}
            or out["gj_n73"][2] != 1 or out["schur_n181"][2] != 2
            or out["factor_n73"][2] != 1):
        fail(f"phase 4g forward-mode rules: {out}, tangent launches of the "
             f"Newton solve {tangent_launches}, fused_rhs raised {raised}")
    say("phase 4g forward-mode rules, the tangent through the kernel vs "
        "through the plain version (per-lane max |d| / max |tangent|, <= 1e-5)"
        " and vs -M dA M in f64 (<= 1e-3): rule 1 gj_inverse n=73 B=64 "
        f"{out['gj_n73'][0]:.3e} / {out['gj_n73'][1]:.3e}, schur_inverse n=181"
        f" B=64 {out['schur_n181'][0]:.3e} / {out['schur_n181'][1]:.3e} (the "
        f"primal's kernel launches only); rule 2 factor n=73 B=64 "
        f"{out['factor_n73'][0]:.3e} / {out['factor_n73'][1]:.3e}; rule 3 "
        f"newton_solve B={Bn} {out[f'newton_b{Bn}'][0]:.3e}, B=1 "
        f"{out['newton_b1'][0]:.3e}, one more kernel launch each for the "
        f"tangent; rule 4 dd_contract tangent vs the plain version's max |d| "
        f"{out['dd'][0]:.1e}, vs dr @ N {out['dd'][1]:.1e}; a dual into "
        f"fused_rhs raised RuntimeError")
    rules = {
        "gj_inverse": ("rule 1 (_gj_inverse_jvp, pallas_linalg.py:203) on "
                       "gj_inverse and schur_inverse; rule 2 (_inv_factor_jvp,"
                       " linalg.py:198) on the factor: -M dA M",
                       {key: out[key][:2] for key in
                        ("gj_n73", "schur_n181", "factor_n73")}),
        "newton_solve": ("rule 3 (_fused_solve_jvp, pallas_linalg.py:445): "
                         "one more launch on db + dc J dy + c dJ dy",
                         {key: out[key][0] for key in
                          (f"newton_b{Bn}", "newton_b1")}),
        "dd_contract": ("rule 4 (_make_dd_matmul._jvp, pallas_matmul.py:206)"
                        ": dr @ N, plain f64", out["dd"][:2]),
        "fused_rhs": ("none in the reference: a dual input raises", raised),
        "grid_probe": ("none: a dual input raises", None)}
    for name, (rule, check) in rules.items():
        kernels[name]["forward_mode_rule"] = rule
        kernels[name]["forward_mode_check_4g"] = check
    kernels["newton_solve"]["tangent_launches_4g"] = tangent_launches


def ramp_sensitivity_method(dev):
    """The variable problem of ``tests/test_sensitivity.py`` at full width:
    700 -> 1100 K at 100 K/s, rates updated every 0.5 s, 4 s in 8 chunks."""
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

    sd, rd, Ea, A = synthetic_pyrolysis_network(N_CARBONS)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=dev)
    cs = ConditionSet({"T": LinearGradientProfile(
        rate=100.0, X_start=700.0, X_end=1100.0)}, ts_update=0.5)
    tf = cs.get_t_final()
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{N_CARBONS}": 1.0}, solve_chunks=True,
        solve_chunkstep=tf / 8, low_k_cutoff="none", abstol=ATOL, reltol=RTOL)
    return VariableODESolve(pars, cs, calc), sd, rd


def _no_rhs_kernel(phase, launches):
    """The sensitivity path: the factor's kernel, and no RHS kernel (those
    have no forward-mode rule; the plain dot runs there)."""
    require_launched(phase, launches, ("gj_inverse",))
    if launches["fused_rhs"] or launches["dd_contract"]:
        fail(f"phase {phase}: an RHS kernel launched on the sensitivity "
             f"path: {launches}")


def phase_sensitivity_static(dev, counts, record, grad11):
    """Phase 14a: forward sensitivities of phase 11's problem over all its
    reactions (one tangent lane each), w @ S[-1] against phase 11's
    adjoint gradient, u against scipy-BDF."""
    from kinetica_tpu_torch.models.mass_action import resolve_clip_delta
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_static

    T, tf = 650.0, 0.05
    method, sd, rd = static_method(dev, T, tf)
    # one segment over [0, tf], as phase 11 integrates it
    method.pars.solve_chunks = False
    w = np.zeros(sd.n)
    w[sd.toInt["C1"]] = 1.0
    counts.reset()
    prob = SensitivityProblem(method, sd, rd, device=dev)
    sens, wall = timed_run(prob.solve)
    launches, syncs = counts.read()
    _no_rhs_kernel("14a", launches)
    st = sens.stats
    fwd = w @ sens.S[-1]
    scale = float(np.abs(grad11).max())
    d = float(np.abs(fwd - grad11).max())
    top = [int(j) for j in np.argsort(-np.abs(grad11))[:3]]
    rel3 = {j: abs(fwd[j] - grad11[j]) / abs(grad11[j]) for j in top}
    k = method.calculator(T).cpu().numpy()
    ref = scipy_bdf_static(sd, rd, k, tf, make_u0(sd, method.pars),
                           REF_RTOL, REF_ATOL,
                           resolve_clip_delta(method.pars))
    err = final_err(sens.u[-1], ref)
    if not (d <= 0.02 * scale and max(rel3.values()) <= 0.02 and err <= 1e-6
            and np.all(np.isfinite(sens.S))):
        fail(f"phase 14a: w @ S[-1] vs the adjoint gradient max |d| {d:.3e} "
             f"(max |grad| {scale:.3e}), top 3 {rel3}; u vs scipy-BDF {err:.3e}")
    steps = st["n_steps"]
    say(f"phase 14a forward sensitivities: phase 11's problem ({rd.nr} rxn / "
        f"{sd.n} sp, static {T:.0f} K, tf {tf} s, one segment), "
        f"rids=None: {st['lanes']} tangent lanes, primal lanes' "
        f"spread {st['lane_spread']:.1e} (0: bit-equal); w @ S[-1] (u_C1) vs phase 11's "
        f"adjoint gradient max |d| {d:.3e} = {d / scale:.2e} of max |grad| "
        f"(<= 2e-2), top 3 "
        + ", ".join(f"{j}: {fwd[j]:.5e} vs {grad11[j]:.5e} ({rel3[j]:.2e})"
                    for j in top)
        + f" (<= 2e-2); u vs scipy-BDF max mole-fraction err {err:.3e}; "
        f"forward steps {steps} (accepted {st['n_accepted']}, factors "
        f"{st['n_lu']}, J evaluations {st['n_jev']}); {wall:.3f} s "
        f"({wall * 1e3 / steps:.3f} ms/step); gj_inverse "
        f"{launches['gj_inverse'] / steps:.3f} launches/step; host syncs "
        f"{syncs / steps:.2f}/step; launches {launches}")
    record("14a", launches, steps)


def phase_sensitivity_ramp(dev, counts, record):
    """Phase 14b: forward sensitivities on the ramp of
    ``tests/test_sensitivity.py`` at full width, 64 rids; u against the
    segment-wise scipy-BDF reference, S against central differences of
    the same solve."""
    from kinetica_tpu_torch.solving.sensitivity import SensitivityProblem
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_discrete_baseline)

    method, sd, rd = ramp_sensitivity_method(dev)
    rids = np.unique(np.concatenate(
        [[0, 3, 7], np.linspace(10, rd.nr - 1, 61).round().astype(int)]))
    counts.reset()
    prob = SensitivityProblem(method, sd, rd, rids=rids, device=dev)
    sens, wall = timed_run(prob.solve)
    launches, syncs = counts.read()
    _no_rhs_kernel("14b", launches)
    st = sens.stats
    pars, cs = method.pars, method.conditions
    t0 = time.perf_counter()
    ref = scipy_bdf_discrete_baseline(sd, rd, method.calculator,
                                      cs.get_profile("T"), pars.tspan,
                                      make_u0(sd, pars), REF_RTOL, REF_ATOL,
                                      cs.get_tstops())
    cpu_s = time.perf_counter() - t0
    err = final_err(sens.u[-1], ref)
    peak = np.abs(sens.S).max(axis=(0, 1))
    cols = [0] + [int(j) + 1 for j in np.argsort(-peak[1:])[:2]]
    eps = 1e-4
    # +-eps on each column, and a centre lane for the quotient's noise
    theta = np.zeros((2 * len(cols) + 1, rids.size))
    for i, col in enumerate(cols):
        theta[2 * i, col], theta[2 * i + 1, col] = eps, -eps
    (ys, status), fd_s = timed_run(lambda: prob._solve_theta(theta))
    ys = ys.cpu().numpy()
    fd = {}
    for i, col in enumerate(cols):
        up, down, mid = ys[2 * i], ys[2 * i + 1], ys[-1]
        scale = float(np.abs(sens.S[1:, :, col]).max())
        fd[int(rids[col])] = (
            float(np.abs(sens.S[1:, :, col] - (up - down) / (2 * eps)).max()
                  / scale),
            float(np.abs(up + down - 2 * mid).max() / (2 * eps) / scale),
            scale)
    # rid 0 (C2 -> 2 CH3, at k_max from the start) is reported, not held:
    # its column is tiny and its quotient's noise as large as its error
    # (the JAX package's tangent is ~100% off it, PERF.md); the two
    # largest columns are held
    held = [int(rids[col]) for col in cols[1:]]
    if not (rids.size == 64 and err <= 1e-6 and bool((status == 1).all())
            and all(fd[j][0] <= 5e-3 + fd[j][1] for j in held)
            and np.all(np.isfinite(sens.S))):
        fail(f"phase 14b: {rids.size} rids; u vs scipy-BDF {err:.3e}; "
             f"central differences (rid: err, noise, max|S|) {fd}; statuses "
             f"{status.tolist()}")
    steps = st["n_steps"]
    say(f"phase 14b forward sensitivities on the ramp (700 -> 1100 K at 100 "
        f"K/s, rates every 0.5 s, tf {pars.tspan[1]} s in {st['n_chunks']} "
        f"chunks; {rd.nr} rxn / {sd.n} sp): {st['lanes']} tangent lanes (rids "
        f"0, 3, 7 and 61 evenly spaced), primal lanes' spread "
        f"{st['lane_spread']:.1e} (0: bit-equal); u vs segment-wise scipy-BDF max "
        f"mole-fraction err {err:.3e} (<= 1e-6; scipy {cpu_s:.3f} s on this "
        f"host); S vs central differences (eps {eps}, {theta.shape[0]} lanes "
        f"of one _solve_theta call, {fd_s:.3f} s) per rid: "
        + ", ".join(f"{j}: {e:.2e} of max|S| {sc:.3e} (noise {nz:.2e})"
                    for j, (e, nz, sc) in fd.items())
        + f" (rids {held}: <= 5e-3 + noise; rid 0 reported); steps {steps} "
        f"(factors {st['n_lu']}, J "
        f"evaluations {st['n_jev']}); {wall:.3f} s ({wall * 1e3 / steps:.3f} "
        f"ms/step); gj_inverse {launches['gj_inverse'] / steps:.3f} "
        f"launches/step; host syncs {syncs / steps:.2f}/step; launches "
        f"{launches}")
    record("14b", launches, steps)


def phase_screening(dev, counts, record, grad11):
    """Phase 15: Morris (phase 11's 63 reactions of largest |grad|, 8
    trajectories, B=512) and Sobol (its top 8, N=64, B=640) on the discrete
    ensemble at phase 11's problem; four design points of each against
    scipy-BDF."""
    from kinetica_tpu_torch.analysis.screening import morris_screening
    from kinetica_tpu_torch.analysis.sobol import sobol_sensitivity
    from kinetica_tpu_torch.models.mass_action import resolve_clip_delta
    from kinetica_tpu_torch.parallel import batching
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_static

    T, tf = 650.0, 0.05
    order = np.argsort(-np.abs(grad11))
    runs = {}
    solve = batching.EnsembleProblem.solve

    def capture(self, *args, **kw):
        ens = solve(self, *args, **kw)
        runs["last"] = (kw["k_tables"], ens)
        return ens

    batching.EnsembleProblem.solve = capture
    try:
        for key, fn, kw in (
                ("morris", morris_screening,
                 dict(rids=order[:63], n_trajectories=8)),
                ("sobol", sobol_sensitivity,
                 dict(rids=order[:8], n_samples=64))):
            method, sd, rd = static_method(dev, T, tf)
            counts.reset()
            res, wall = timed_run(lambda: fn(method, sd, rd, objective="C1",
                                             device=dev, **kw))
            launches, syncs = counts.read()
            runs[key] = (res, wall, launches, syncs) + runs.pop("last")
    finally:
        batching.EnsembleProblem.solve = solve
    u0 = make_u0(sd, method.pars)
    delta = resolve_clip_delta(method.pars)
    lines = []
    for key, (res, wall, launches, syncs, k_tables, ens) in runs.items():
        B = k_tables.shape[0]
        require_launched(f"15 {key}", launches,
                         ("fused_rhs", "gj_inverse", "grid_probe"))
        errs = {}
        for b in (0, B // 3, 2 * B // 3, B - 1):
            ref = scipy_bdf_static(sd, rd, k_tables[b, 0], tf, u0, REF_RTOL,
                                   REF_ATOL, delta)
            errs[b] = final_err(ens.u[b, -1], ref)
        if not (ens.success and res.failed_points == 0
                and max(errs.values()) <= 1e-6):
            fail(f"phase 15 {key}: B={B}, failed points {res.failed_points}, "
                 f"design points vs scipy-BDF {errs}")
        steps = int(np.asarray(ens.stats["n_steps"]).max())
        score = res.mu_star if key == "morris" else res.ST
        top = [(int(res.rids[j]), float(score[j]))
               for j in np.argsort(-score)[:5]]
        lines.append(
            f"{key} B={B}: all DONE, failed points 0, design points "
            + ", ".join(f"{b}: {e:.2e}" for b, e in errs.items())
            + " vs scipy-BDF (<= 1e-6); top 5 by "
            + ("mu_star " if key == "morris" else "total index ")
            + ", ".join(f"{j}: {v:.4e}" for j, v in top)
            + f"; {wall:.3f} s, steps max {steps} ({wall * 1e3 / steps:.3f} "
            f"ms/step), host syncs {syncs / steps:.2f}/step, launches "
            f"{launches}")
        record(f"15_{key}", launches, steps)
    say("phase 15 Morris and Sobol on the discrete ensemble at phase 11's "
        "problem (objective u_C1(tf), span 1 decade): " + " | ".join(lines))


def phase_analysis(dev, counts, record, tmp):
    """Phase 16: member 0's ramp of phase 6 cut to 2 s (4 chunks, saves
    every 0.02 s): DRG and DRGEP reductions for C2e, fluxes, and the
    save/load round trip."""
    from kinetica_tpu_torch.analysis.flux import reaction_fluxes
    from kinetica_tpu_torch.analysis.io import load_output, save_output
    from kinetica_tpu_torch.analysis.reduction import (reduce_network_drg,
                                                       reduce_network_drgep)
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)

    tf, tol, ladder = 4 * CHUNK, 1e-5, [0.1, 0.03, 0.01, 0.003]
    sd, rd, calc, conds, pars = build_problem(
        dev, tf=tf, linsolve="inv_fused", rhs_contraction="dd",
        save_interval=0.02)
    method = VariableODESolve(pars, conds[0], calc)
    counts.reset()
    full, full_s = timed_run(lambda: solve_network(method, sd, rd, device=dev))
    launches, syncs = counts.read()
    require_launched(16, launches, ("dd_contract", "newton_solve",
                                    "gj_inverse", "grid_probe"))
    steps = full.sol.stats["n_steps"]
    record("16", launches, steps)
    # The kept set below eps 0.1 follows concentrations far under abstol:
    # on the card's trajectory both rules keep the whole network at eps
    # 0.03, so the accepted mechanism need not be a reduction. Each
    # ladder is held to the plain versions' on the CPU from the same
    # trajectory (the same kept sets, each re-solved rung's error within
    # 1e-6), and at least one rung must be a reduction re-solved here.
    _, _, calc_c, conds_c, pars_c = build_problem(
        "cpu", tf=tf, linsolve="inv_fused", rhs_contraction="dd",
        save_interval=0.02)
    method_c = VariableODESolve(pars_c, conds_c[0], calc_c)
    results = {}
    for name, fn in (("DRG", reduce_network_drg),
                     ("DRGEP", reduce_network_drgep)):
        res, wall = timed_run(lambda: fn(method, sd, rd, targets=["C2e"],
                                         tol=tol, eps_ladder=ladder,
                                         full_output=full, device=dev))
        res_c = fn(method_c, sd, rd, targets=["C2e"], tol=tol,
                   eps_ladder=ladder, full_output=full, device="cpu")
        red, red_c = res.reduction, res_c.reduction
        same = (len(res.ladder) == len(res_c.ladder)
                and all(a[:3] == b[:3] and (a[3] == b[3]
                                            or abs(a[3] - b[3]) <= 1e-6)
                        for a, b in zip(res.ladder, res_c.ladder))
                and np.array_equal(red.keep_species, red_c.keep_species)
                and list(red.keep_rids) == list(red_c.keep_rids))
        reduced = [r for r in res.ladder
                   if 0 < r[2] < rd.nr and np.isfinite(r[3])]
        if not (res.error <= tol and same and reduced):
            fail(f"phase 16 {name}: error {res.error:.3e} (tol {tol}), "
                 f"{red.n_reactions}/{rd.nr} reactions; ladder {res.ladder}, "
                 f"on the CPU {res_c.ladder}")
        results[name] = (res, wall, res_c)
    u = full.sol.u
    try:
        reaction_fluxes(full, calc, check=True)
        trapezoid = "passed its checks"
    except ValueError as exc:
        if "startup" not in str(exc):
            raise
        trapezoid = "refused (startup guard: an unresolved ignition burst)"
    flux = reaction_fluxes(full, calc, check=True, attribution="projected")
    net_err = float(np.abs(flux.net_production - (u[-1] - u[0])).max())
    if not (net_err <= 1e-8 and np.all(np.isfinite(flux.extent))):
        fail(f"phase 16 fluxes: net production vs u(tf) - u(0) {net_err:.3e}")
    path = os.path.join(tmp, "phase16.npz")
    save_output(full, path)
    back = load_output(path)
    same = (np.array_equal(back.sol.t, full.sol.t)
            and np.array_equal(back.sol.u, full.sol.u)
            and set(back.sol.vcs) == set(full.sol.vcs)
            and all(np.array_equal(back.sol.vcs[k], v)
                    for k, v in full.sol.vcs.items())
            and back.rd.nr == rd.nr and back.sd.toInt == full.sd.toInt
            and vars(back.pars) == vars(full.pars))
    if not same:
        fail("phase 16: save_output -> load_output is not bit for bit")
    say(f"phase 16 analysis: phase 6's member 0 cut to tf {tf} s "
        f"({tf / CHUNK:.0f} chunks, saves every 0.02 s; {rd.nr} rxn / {sd.n} "
        f"sp): full solve {full_s:.3f} s, {steps} steps; "
        + "; ".join(
            f"{n} for C2e (eps ladder {ladder}, tol {tol}): accepted eps "
            f"{r.reduction.eps:g}, {r.reduction.n_reactions}/{rd.nr} "
            f"reactions, {r.reduction.n_species}/{sd.n} species, error "
            f"{r.error:.3e}; ladder "
            + ", ".join(f"{e:g}: {nr} rxn {er:.2e}" for e, _, nr, er in r.ladder)
            + f" ({w:.3f} s), the CPU's from this trajectory the same kept "
            "sets, errors " + ", ".join(f"{er:.2e}" for *_, er in rc.ladder)
            for n, (r, w, rc) in results.items())
        + f"; reaction_fluxes: trapezoid {trapezoid}; projected net "
        f"production vs u(tf) - u(0) {net_err:.3e} (<= 1e-8), top extents "
        f"{[(j, float(f'{v:.6g}')) for j, v in flux.top(3)]}; save_output -> "
        f"load_output bit for bit; launches {launches} "
        f"({sum(launches.values()) / steps:.2f}/step)")


def mole_err(u, ref):
    """Max mole-fraction difference over (..., ns) states."""
    return float(np.max(np.abs(u - ref)
                        / np.maximum(ref.sum(axis=-1, keepdims=True), 1.0)))


def _discrete_reference(job):
    """One gate member's scipy-BDF trajectory (a worker process's job)."""
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_discrete_trajectory)
    return scipy_bdf_discrete_trajectory(*job)


def check_gate_kernels(dev, gate_log):
    """Phase 17's two kernels against their plain versions at each gate's
    shapes (B=64, 4-15 species, 4-44 reactions): the fused RHS on the
    gate's own network, Gauss-Jordan on well-conditioned (64, n, n)
    matrices; made after the launch counts were read."""
    import torch
    from kinetica_tpu_torch.models.mass_action import augment, build_mass_action
    from kinetica_tpu_torch.ops import gj_inverse
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    from kinetica_tpu_torch.testing.kernel_cases import rhs_rel_err

    rng = np.random.default_rng(17)
    out = []
    for entry in gate_log:
        sd, rd = entry["sd"], entry["rd"]
        n = sd.n
        net = build_mass_action(rd, n, device=dev)
        fused = FusedMassActionRHS(net.N, net.reac_slots, dev)
        u = 10.0 ** rng.uniform(-14, 0, (BATCH, n))
        u_aug = augment(torch.as_tensor(u, device=dev), net.delta).contiguous()
        k = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (BATCH, rd.nr)),
                            device=dev)
        rel = rhs_rel_err(fused, u_aug, k, fused(u_aug, k))
        A = torch.as_tensor(np.eye(n) + rng.standard_normal((BATCH, n, n))
                            / (2.0 * np.sqrt(n)), device=dev).float()
        M_k = gj_inverse.gj_inverse(A)
        M_p = gj_inverse.gj_inverse_plain(A)
        gj = float(((M_k.double() - M_p.double()).norm(dim=(1, 2))
                    / M_p.double().norm(dim=(1, 2))).max())
        if not (rel <= 1e-12 and gj <= 1e-5):
            fail(f"phase 17 kernels at level {entry['level']} (ns {n}, nr "
                 f"{rd.nr}): fused_rhs max |d| / sum|N r| {rel:.3e} (<= "
                 f"1e-12), gj_inverse max rel Frobenius {gj:.3e} (<= 1e-5)")
        out.append(f"ns {n} nr {rd.nr}: fused_rhs {rel:.2e}, gj_inverse "
                   f"{gj:.2e}")
    return "; ".join(out)


def phase_explore(dev, counts, record, tmp, pool):
    """Phase 17: BASELINE config 5 (``scripts/bench_explore.py 64``) on the
    card: 4 levels from CC over cde_lite, each gated by the 64-ramp
    discrete ensemble; sizes against the JAX package's record, members 0
    and 63 of every gate against scipy-BDF, the seeds against those
    references. The references run in ``pool``; returns the final network
    and the function that waits for them and checks the gates."""
    import random

    import torch
    from kinetica_tpu_torch.analysis.io import load_output
    from kinetica_tpu_torch.chem import native
    from kinetica_tpu_torch.exploration import explore_network
    from kinetica_tpu_torch.exploration.cde_lite import build_cde_lite
    from kinetica_tpu_torch.ops.cuda_build import BUILD_DIR
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.explore_config import RECORD, config5

    random.seed(0)
    em, sm, conds = config5(tmp, batch=BATCH, device=dev)
    pars, calc = sm.pars, sm.calculator
    lanes = (0, BATCH - 1)
    counts.reset()
    t0 = time.perf_counter()
    res = explore_network(em, sm, savedir=os.path.join(tmp, "out"), device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    sizes = [(t["n_species"], t["n_reactions"]) for t in em.timings]
    if sizes != list(RECORD):
        fail(f"phase 17: species/reactions by level {sizes}, the JAX "
             f"package's record {list(RECORD)}")
    require_launched(17, launches, ("fused_rhs", "gj_inverse"))
    exe = build_cde_lite()
    for what, path in (("chem-lite library", native.lib_path),
                       ("cde_lite", exe)):
        if path is None or os.path.dirname(str(path)) != str(BUILD_DIR):
            fail(f"phase 17: the {what} was not built under {BUILD_DIR}: {path}")
    back = load_output(os.path.join(tmp, "out", "level_network_1-4.npz"))
    if not (back.sd.toInt == res.sd.toInt and back.rd.nr == res.rd.nr
            and np.array_equal(back.sol.u, em.gate_log[-1]["sol"].u[0])):
        fail("phase 17: level_network_1-4.npz does not load back as member 0")
    lines = []
    for entry, t in zip(em.gate_log, em.timings):
        sol = entry["sol"]
        if not sol.success or not np.all(np.isfinite(sol.u)):
            fail(f"phase 17 level {entry['level']}: {sol.retcodes}")
        steps = t["n_steps_max"]
        lines.append(
            f"L{entry['level']} {entry['sd'].n} sp/{entry['rd'].nr} rxn: "
            f"explore_s {t['explore_s']}, solve_s {t['solve_s']}, seeds_s "
            f"{t['seeds_s']}, steps max {steps}, "
            f"{t['solve_s'] * 1e3 / steps:.3f} ms/step, host syncs "
            f"{t['host_syncs'] / steps:.2f}/step")
    # once member 63 (1400 K) nears its equilibrium scipy-BDF's step
    # stalls near 1e-5 s (~2.5e4 steps a 1 s chunk, against ~70 of the
    # port's BDF), so the references run side by side, beside the later
    # phases
    futures = [pool.submit(_discrete_reference, (
        e["sd"], e["rd"], calc, conds[b].get_profile("T"), e["sol"].t,
        make_u0(e["sd"], pars), pars.reltol, pars.abstol,
        conds[b].get_tstops())) for e in em.gate_log for b in lanes]
    steps_all = sum(t["n_steps_max"] for t in em.timings)
    record("17", launches, steps_all)
    kernel_line = check_gate_kernels(dev, em.gate_log)
    say(f"phase 17 config 5 exploration (B={BATCH}, {len(em.timings)} levels, "
        f"discrete 40-80 K/s ramps from 600 K): species/reactions by level "
        f"{sizes} = the JAX record; {total_s:.2f} s end to end; native "
        f"chem-lite and cde_lite built under _build/; level_network_1-4.npz "
        f"loads back; launches {launches} "
        f"({sum(launches.values()) / steps_all:.2f}/step over {steps_all} "
        f"steps); host syncs {syncs}; " + " | ".join(lines)
        + f" | kernels vs plain at the gates' shapes (B={BATCH}): "
        + kernel_line)

    def check_references():
        t1 = time.perf_counter()
        refs_all = [f.result() for f in futures]
        wait_s = time.perf_counter() - t1
        lines = []
        for i, entry in enumerate(em.gate_log):
            sol, sd = entry["sol"], entry["sd"]
            refs = np.stack(refs_all[i * len(lanes):(i + 1) * len(lanes)])
            err = mole_err(sol.u[list(lanes)], refs)
            ref_max = refs.reshape(-1, sd.n).max(axis=0)
            ref_seeds = [sd.toStr[j] for j in range(sd.n)
                         if ref_max[j] >= em.seed_conc]
            card_max = sol.u.reshape(-1, sd.n).max(axis=0)
            if err > 1e-6 or ref_seeds != entry["next_seeds"]:
                fail(f"phase 17 level {entry['level']}: members {lanes} vs "
                     f"scipy-BDF {err:.3e} (> 1e-6?); seeds card "
                     f"{entry['next_seeds']}, scipy-BDF {ref_seeds}; margins "
                     + ", ".join(f"{sd.toStr[j]} {card_max[j]:.6f}"
                                 for j in range(sd.n)))
            lines.append(
                f"L{entry['level']}: {err:.3e}, {len(ref_seeds)} seeds equal "
                f"(least margin to {em.seed_conc}: "
                f"{np.abs(card_max - em.seed_conc).min():.4f})")
        say(f"phase 17 references: members 0/{BATCH - 1} of every gate vs "
            f"scipy-BDF (<= 1e-6) and the seeds recomputed from them "
            f"({len(futures)} references in a process pool beside phases "
            f"18-20, waited {wait_s:.2f} s after them): "
            + " | ".join(lines))

    return res, check_references


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def phase_calculators(dev, counts, record, tmp, sd17, rd17):
    """Phase 18: (a) the KPM calculators on phase 17's final network, card
    against CPU, and a 64-ramp continuous sweep with the collision
    calculator against scipy-BDF; (b) the fake-ASE ASENEBCalculator on
    CC <-> C=C + H2 and a TSTCalculator at the nc=24 width, card against
    CPU."""
    import torch
    from kinetica_tpu_torch import constants
    from kinetica_tpu_torch.ase.thermo_check import numpy_enthalpy, numpy_entropy
    from kinetica_tpu_torch.calculators import kpm, tst
    from kinetica_tpu_torch.chem import frame_from_smiles
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing import device_timing, fake_ase
    from kinetica_tpu_torch.testing.cpu_reference import (
        collision_k_of_t, scipy_bdf_trajectory)
    from kinetica_tpu_torch.testing.explore_config import config5
    from kinetica_tpu_torch.testing.synthetic import (
        seeded_kpm_params, synthetic_pyrolysis_network,
        synthetic_thermo_tables, write_kpm_npz)
    from kinetica_tpu_torch.testing.tst_bounds import (entropy_abs_bound,
                                                       rate_rel_bound)

    t_start = time.perf_counter()
    cpu = torch.device("cpu")
    T64 = np.linspace(600.0, 1400.0, BATCH)
    model = os.path.join(tmp, "kpm_model.npz")
    write_kpm_npz(model, seeded_kpm_params(seed=3))
    # (a) the four KPM set-ups, card against CPU
    errs = {}
    setups = (("basic", kpm.KPMBasicCalculator, {}),
              ("collision", kpm.KPMCollisionCalculator, {}),
              ("collision_inert", kpm.KPMCollisionCalculator,
               {"inert_species": ["[Ar]"]}),
              ("collision_entropy", kpm.KPMCollisionEntropyCalculator, {}))
    for name, cls, kw in setups:
        out = []
        for d in (dev, cpu):
            sd, rd = sd17.copy(), rd17.copy()
            calc = cls(kpm.KPMRun(model, device=d), uncertainty=True,
                       k_max=1e12, device=d, **kw)
            calc.setup_network(sd, rd)
            out.append((calc, [calc(T=900.0),
                               calc(T=torch.as_tensor(T64, device=d))]))
        (c_d, k_d), (c_c, k_c) = out
        ev = c_d.Ea.cpu().numpy() / constants.eV_to_J_per_mol
        if not (c_d.Ea.device == dev and np.all((ev > 0.8) & (ev < 2.0))):
            fail(f"phase 18 {name}: Ea on {c_d.Ea.device}, range "
                 f"{ev.min():.3f}-{ev.max():.3f} eV (0.8-2.0)")
        e = max(_rel(c_d.Ea.cpu(), c_c.Ea), _rel(c_d.Ea_std.cpu(), c_c.Ea_std),
                *(_rel(a.cpu(), b) for a, b in zip(k_d, k_c)))
        if e > 1e-12 or k_d[1].shape != (BATCH, rd.nr):
            fail(f"phase 18 {name}: card vs CPU max relative {e:.3e} (> 1e-12)"
                 f" or shape {tuple(k_d[1].shape)}")
        errs[name] = e
        if name == "collision":
            coll_cpu = c_c
    # the 64-ramp continuous sweep with the collision calculator
    _, sm, conds = config5(os.path.join(tmp, "kpm_sweep"), batch=BATCH,
                           device=dev)
    pars = sm.pars
    calc = kpm.KPMCollisionCalculator(kpm.KPMRun(model, device=dev),
                                      k_max=1e12, device=dev)
    method = VariableODESolve(pars, conds[0], calc)
    counts.reset()
    prob = EnsembleProblem(method, sd17, rd17, rate_mode="continuous",
                           device=dev)
    ens, sweep_s = timed_run(lambda: prob.solve(conditions_list=conds))
    launches, syncs = counts.read()
    require_launched("18", launches, ("fused_rhs", "gj_inverse"))
    steps = int(np.max(ens.stats["n_steps"]))
    record("18", launches, steps)
    t1 = time.perf_counter()
    u0 = make_u0(prob.sd, pars)
    refs = np.stack([scipy_bdf_trajectory(
        prob.sd, prob.rd, collision_k_of_t(
            coll_cpu.Ea.numpy(), coll_cpu.mu.numpy(), coll_cpu.sigma.numpy(),
            coll_cpu.rho.numpy(), 1e12, 1.0, conds[b].get_profile("T")),
        ens.t, u0, REF_RTOL, REF_ATOL) for b in (0, BATCH - 1)])
    ref_s = time.perf_counter() - t1
    sweep_err = mole_err(ens.u[[0, BATCH - 1]], refs)
    if not ens.success or sweep_err > 1e-6:
        fail(f"phase 18 KPM sweep: {ens.retcodes}; members 0/{BATCH - 1} vs "
             f"scipy-BDF {sweep_err:.3e} (> 1e-6)")
    # (b) the fake-ASE pipeline: the NEB and vibrations on the host, the
    # TST rates on the card
    smis = ["CC", "C=C", "[H][H]"]
    sd = SpeciesData(smis, [frame_from_smiles(s) for s in smis])
    rd = RxData()
    rd.push(sd, [["CC"]], [["C=C", "[H][H]"]])
    rd.push(sd, [["C=C", "[H][H]"]], [["CC"]])
    fake_ase.install()
    try:
        from kinetica_tpu_torch.ase.calculator import ASENEBCalculator
        neb = ASENEBCalculator(
            calc_builder=fake_ase.ToyMorseBuilder(),
            calcdir=os.path.join(tmp, "aseneb"), n_images=5,
            neb_optimiser="fire", climb=False, ftol=0.3, geom_fmax=0.05,
            maxiters=400, interpolation="linear", remove_unconverged=False,
            device=dev)
        neb.setup_network(sd, rd)
    finally:
        fake_ase.uninstall()
    T7 = np.linspace(800.0, 1400.0, 7)
    k_card = neb(T=torch.as_tensor(T7, device=dev), P=1e5)
    t_card = neb._tst
    t_cpu = tst.TSTCalculator(t_card.species, t_card.ts, rd.id_reacs,
                              rd.stoic_reacs, device=cpu)
    k_cpu = t_cpu(T=torch.as_tensor(T7), P=1e5)
    if not (k_card.device == dev and neb.ts_cache["conv"]
            == {0: True, 1: True}):
        fail(f"phase 18 ASE-NEB: rates on {k_card.device}, NEB converged "
             f"{neb.ts_cache['conv']}")
    rel = (np.abs(k_card.cpu().numpy() / k_cpu.numpy() - 1.0)
           / (1e-12 + rate_rel_bound(t_card, T7)))
    # the card's thermo of every species and TS against thermo_check's
    # numpy formulas, beyond the same conditioning
    th = 0.0
    for tab in (t_card.species, t_card.ts):
        dtab = tab.to(dev)
        Tb = torch.full((1, 1), 1000.0, dtype=torch.float64, device=dev)
        S = tst.entropy(dtab["mass"], dtab["inertias"], dtab["geometry"],
                        dtab["symmetry"], dtab["mult"], dtab["vib_energies"],
                        dtab["vib_mask"], Tb, 1e5)[0].cpu().numpy()
        H = tst.enthalpy(dtab["energy"], dtab["vib_energies"],
                         dtab["vib_mask"], dtab["geometry"], Tb)[0].cpu().numpy()
        S_b = entropy_abs_bound(tab, [1000.0])[0]
        for i in range(tab.mass.shape[0]):
            vibs = tab.vib_energies[i][tab.vib_mask[i]]
            S_np = numpy_entropy(tab.mass[i], tab.inertias[i],
                                 int(tab.geometry[i]), tab.symmetry[i],
                                 tab.mult[i], vibs, 1000.0, 1e5)
            H_np = numpy_enthalpy(tab.energy[i], vibs, int(tab.geometry[i]),
                                  1000.0)
            th = max(th, abs(S[i] - S_np) / (1e-12 * abs(S_np) + S_b[i]),
                     abs(H[i] - H_np) / (1e-12 * abs(H_np)))
    if rel.max() > 1.0 or th > 1.0:
        fail(f"phase 18 ASE-NEB: card vs CPU rates {rel.max():.3f} of their "
             f"bound, thermo vs numpy {th:.3f} of its bound")
    # a TSTCalculator of seeded tables at the nc=24 width
    sd24, rd24, _, _ = synthetic_pyrolysis_network(N_CARBONS)
    tabs = synthetic_thermo_tables(sd24, rd24, seed=5)
    c24 = tst.TSTCalculator(*tabs, device=dev)
    c24c = tst.TSTCalculator(*tabs, device=cpu)
    k24 = c24(T=torch.as_tensor(T64, device=dev), P=1e5)
    e24 = _rel(k24.cpu(), c24c(T=torch.as_tensor(T64), P=1e5))
    ms24 = device_timing.event_ms(
        lambda: c24(T=torch.as_tensor(T64, device=dev), P=1e5))
    if k24.shape != (BATCH, rd24.nr) or e24 > 1e-12:
        fail(f"phase 18 TST nc={N_CARBONS}: shape {tuple(k24.shape)}, card vs "
             f"CPU {e24:.3e} (> 1e-12)")
    say(f"phase 18 calculators: (a) KPM on phase 17's network ({rd17.nr} rxn "
        f"/ {sd17.n} sp, 5-member 16-64-64-1 ensemble, Ea "
        f"{ev.min():.3f}-{ev.max():.3f} eV): card vs CPU max relative (Ea, "
        f"Ea_std, k at 900 K and at T ({BATCH},)) "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (<= 1e-12); continuous {BATCH}-ramp sweep with the collision "
        f"calculator: {sweep_s:.3f} s, steps max {steps}, "
        f"{sweep_s * 1e3 / steps:.3f} ms/step, host syncs "
        f"{syncs / steps:.2f}/step, members 0/{BATCH - 1} vs scipy-BDF "
        f"{sweep_err:.3e} (<= 1e-6; reference {ref_s:.2f} s), launches "
        f"{launches} ({sum(launches.values()) / steps:.2f}/step) | (b) "
        f"ASE-NEB over the fake ASE, CC <-> C=C + H2: card vs CPU rates at "
        f"T (7,) within {rel.max():.3f} of 1e-12 + the log1p(-exp(-x)) "
        f"conditioning of the pipeline's near-zero modes (max relative "
        f"{_rel(k_card.cpu(), k_cpu):.2e}); thermo of every species and TS "
        f"vs thermo_check's numpy formulas within {th:.3f} of that bound; "
        f"TSTCalculator nc={N_CARBONS} ({sd24.n} species, {rd24.nr} TS) at T "
        f"({BATCH},): card vs CPU {e24:.3e} (<= 1e-12), {ms24:.3f} ms a call "
        f"| phase 18 {time.perf_counter() - t_start:.1f} s")


# phase 19's members: 8 of phase 5's 64 ramps, member 0 first
SHARD_MEMBERS = slice(0, BATCH, 8)
M22 = ((2, 2), ("batch", "model"))


def _worst_ratio(u, ref, rtol, atol):
    """max |u - ref| / (atol + rtol |ref|): <= 1 where u is within."""
    return float(np.max(np.abs(u - ref) / (atol + rtol * np.abs(ref))))


# phase 19b's horizon, cut from TF to fit phases 19-20 in ~150 s: at 7 s
# the discrete sharded solve took 3729 steps and 115 s on the card
SHARD_TF = 2 * CHUNK
# the bound of a sharded solve against the unsharded one (mole fraction):
# twice the spread of two equally valid unsharded solves of the same
# members on the card (5.0e-9, B=64 vs B=8), which already exceeds the
# reference's rtol/atol by up to 5.8x (segment-sum against matmul J)
SHARD_MAX_DIFF = 1e-8


def phase_sharded(dev, record_ranks, ens5, ens7):
    """Phase 19: the sharded ensemble over four gloo ranks sharing the card
    (``kinetica_tpu_torch.testing.sharded_ranks``), 8 of phase 5's ramps
    at the full width, each over the ramps' first two chunks (1 s): 19a a
    (batch=2, model=2) mesh, phase 5's continuous configuration; 19b the
    same mesh, phase 7's discrete one; 19c a (4,) batch mesh, continuous.
    Every rank's solution must be bit-equal to every other's (the model
    ranks' loops identical), within ``SHARD_MAX_DIFF`` of the unsharded
    solve of the same members on the card (19a, 19c: B=8 here; 19b: phase
    7's rows), 19c's last block within the batch axis's tolerance of its
    unsharded B=2 solve, member 0 within 1e-6 of scipy-BDF, and each
    rank's block kernels within 1e-12 of sum|N r| of their plain versions
    at the shard's shape (B=4, nr=548). The reference's model-axis
    tolerance is printed beside the spread between phase 5's and the B=8
    unsharded solve of the same members."""
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_baseline, scipy_bdf_discrete_baseline)
    from kinetica_tpu_torch.testing.sharded_ranks import (ramp_problem,
                                                          run_ranks)
    rates = [float(r) for r in np.linspace(40.0, 60.0, BATCH)[SHARD_MEMBERS]]
    pars = dict(abstol=ATOL, reltol=RTOL, jac_policy="lazy", lu_drift_tol=0.3,
                linsolve="auto", rhs_contraction="auto")
    base = dict(network=N_CARBONS, rates=rates, X0=500.0, tf=SHARD_TF,
                chunk=CHUNK,
                u0={f"C{N_CARBONS}": 1.0}, pars=pars)
    cases = [
        dict(base, name="19a", ts_update=None, rate_mode="continuous",
             mesh=M22, sharding=M22, check_kernels=True),
        dict(base, name="19b", ts_update=TS_UPDATE, mesh=M22, sharding=M22,
             check_kernels=True,
             pars=dict(pars, linsolve="inv_fused", rhs_contraction="dd")),
        dict(base, name="19c", ts_update=None, rate_mode="continuous",
             sharding=((4,), ("batch",)))]

    t0 = time.perf_counter()
    method, sd, rd, conds = ramp_problem(cases[0], dev)
    plain, plain_s = timed_run(lambda: EnsembleProblem(
        method, sd, rd, rate_mode="continuous", device=dev).solve(
            conditions_list=conds))
    # lanes round by their place in the batch: 19c's last block, members
    # 6-7, is held to the unsharded solve of the same block
    block = EnsembleProblem(method, sd, rd, rate_mode="continuous",
                            device=dev).solve(conditions_list=conds[6:])
    if not (plain.success and block.success):
        fail(f"phase 19: the unsharded solves {plain.retcodes}, "
             f"{block.retcodes}")
    _, cont_final = scipy_bdf_baseline(
        sd, rd, method.calculator, conds[0].get_profile("T"),
        method.pars.tspan, make_u0(sd, method.pars), RTOL, ATOL, best_of=1)
    method_b, sd_b, rd_b, conds_b = ramp_problem(cases[1], dev)
    conds_b[0].solve_variable_conditions(method_b.pars)
    disc_final = scipy_bdf_discrete_baseline(
        sd_b, rd_b, method_b.calculator, conds_b[0].get_profile("T"),
        method_b.pars.tspan, make_u0(sd_b, method_b.pars), RTOL, ATOL,
        conds_b[0].get_tstops())
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        ranked = run_ranks(4, {"device": dev.type, "timeout_s": 300,
                               "cases": cases}, wait_s=900)
    except (RuntimeError, TimeoutError) as exc:
        fail(f"phase 19: the ranks failed: {exc}")
    ranks_s = time.perf_counter() - t0
    n_b = int(SHARD_TF / CHUNK) + 1
    refs = {"19a": (plain.u, 5e-4), "19c": (plain.u, 5e-4),
            "19b": (ens7.u[SHARD_MEMBERS, :n_b], 1e-4)}
    u5 = ens5.u[SHARD_MEMBERS, :n_b]
    spread = float(np.max(np.abs(u5 - plain.u)))
    spread_r = _worst_ratio(u5, plain.u, 5e-4, 1e-10)
    finals = {"19a": cont_final, "19b": disc_final, "19c": cont_final}
    needed = {"19a": ("fused_rhs", "gj_inverse", "grid_probe"),
              "19b": ("dd_contract", "newton_solve", "gj_inverse",
                      "grid_probe"),
              "19c": ("fused_rhs", "gj_inverse", "grid_probe")}
    walls, failed = [], []
    for case in cases:
        name = case["name"]
        rs = [r[name] for r in ranked]
        u = rs[0]["u"]
        if not all(r["retcodes"] == ["Success"] * len(rates) for r in rs):
            fail(f"phase {name}: not every lane DONE: "
                 f"{[r['retcodes'] for r in rs]}")
        if u.shape != (len(rates), 1 + round(case["tf"] / CHUNK), sd.n) or \
                not np.all(np.isfinite(u)):
            fail(f"phase {name}: bad solution array {u.shape}")
        if not all(np.array_equal(r["u"], u) and r["rank_spread"] == 0.0
                   for r in rs):
            fail(f"phase {name}: the ranks' solutions differ (spreads "
                 f"{[r['rank_spread'] for r in rs]})")
        ref, rtol = refs[name]
        d_max = float(np.max(np.abs(u - ref)))
        held = (f"vs unsharded {'phase 7' if name == '19b' else 'B=8'} max "
                f"|d| {d_max:.3e} (<= {SHARD_MAX_DIFF:g}; "
                f"{_worst_ratio(u, ref, rtol, 1e-10):.3f} of rtol {rtol} / "
                f"atol 1e-10)")
        if not d_max <= SHARD_MAX_DIFF:
            failed.append(f"phase {name}: sharded vs unsharded max |d| "
                          f"{d_max:.3e} (> {SHARD_MAX_DIFF:g})")
        if name == "19c":
            ratio_b = _worst_ratio(u[6:], block.u, 1e-6, 1e-12)
            held += (f"; members 6-7 vs their unsharded B=2 solve "
                     f"{ratio_b:.3f} of rtol 1e-6 / atol 1e-12 (max |d| "
                     f"{float(np.max(np.abs(u[6:] - block.u))):.3e})")
            if not ratio_b <= 1.0:
                failed.append(f"phase 19c: members 6-7 vs their B=2 solve "
                              f"off by {ratio_b:.3f} of rtol 1e-6 / 1e-12")
        err0 = final_err(u[0, -1], finals[name])
        if err0 > 1e-6:
            failed.append(f"phase {name}: member 0 vs scipy-BDF {err0:.3e}")
        for rank, r in enumerate(rs):
            require_launched(f"{name} rank {rank}", r["launches"],
                             needed[name])
        kern = ""
        if case.get("check_kernels"):
            errs = [(r["kernels"]["fused_rhs"], r["kernels"]["dd_contract"])
                    for r in rs]
            shapes = {tuple(r["kernels"]["shape"]) for r in rs}
            blocks = [tuple(r["block"]) for r in rs]
            nr = rd.nr + rd.nr % 2      # padded to the model axis
            if (shapes != {(len(rates) // 2, nr // 2, sd.n)}
                    or not max(max(e) for e in errs) <= 1e-12
                    or {r["nr"] for r in rs} != {nr}):
                failed.append(f"phase {name}: block kernels {errs} at "
                              f"{shapes}, blocks {blocks}")
            kern = (f"; block kernels at (B, nr, ns) {sorted(shapes)} vs "
                    f"plain, max |d| / sum|N r| fused_rhs "
                    f"{max(e[0] for e in errs):.3e}, dd_contract "
                    f"{max(e[1] for e in errs):.3e}; blocks {blocks}")
        steps = rs[0]["n_steps"]
        s_max, s_med = int(steps.max()), int(np.median(steps))
        wall = max(r["wall_s"] for r in rs)
        walls.append(wall)
        per_rank = [{k: round(v / s_max, 3) for k, v in r["launches"].items()
                     if v} for r in rs]
        record_ranks(name, [r["launches"] for r in rs], s_max)
        say(f"phase {name} sharded ensemble, mesh "
            f"{case['sharding'][0]} {case['sharding'][1]} over 4 gloo ranks "
            f"on one card, {case.get('rate_mode', 'discrete')}, tf "
            f"{case['tf']} s, {case['pars']['linsolve']} + "
            f"{case['pars']['rhs_contraction']}: all DONE, ranks bit-equal; "
            f"{held}; member 0 vs scipy-BDF {err0:.3e}; wall {wall:.3f} s; "
            f"steps max/median {s_max}/{s_med}; "
            f"{wall * 1e3 / s_max:.3f} ms/step; per rank host syncs/step "
            f"{[round(r['host_syncs'] / s_max, 2) for r in rs]}, all_reduce/"
            f"step {[round(r['all_reduces'] / s_max, 2) for r in rs]}, "
            f"all_reduce share of wall "
            f"{[round(r['all_reduce_s'] / r['wall_s'], 3) for r in rs]}; "
            f"launches/step per rank {per_rank}{kern}")
    p_steps = int(plain.stats["n_steps"].max())
    say(f"phase 19: {ranks_s:.1f} s of ranks ({ranks_s - sum(walls):.1f} s "
        f"start-up and set-up), references {refs_s:.1f} s (unsharded B=8 "
        f"continuous {plain_s:.3f} s, {p_steps} steps, "
        f"{plain_s * 1e3 / p_steps:.3f} ms/step); two unsharded solves of the "
        f"same members (phase 5's B=64, B=8) part by max |d| {spread:.3e}, "
        f"{spread_r:.3f} of rtol 5e-4 / atol 1e-10")
    if failed:
        fail("; ".join(failed))


def trace_events(path):
    """(category, name) of every event of a Chrome trace. Kineto writes an
    event's "cat" just before its "name", so a regex reads a trace of
    millions of events in seconds; a trace laid out otherwise is parsed
    as JSON."""
    with open(path) as fh:
        text = fh.read()
    pairs = re.findall(r'"cat":\s*"([^"]*)",\s*"name":\s*"((?:[^"\\]|\\.)*)"',
                       text)
    if pairs:
        return pairs
    return [(e.get("cat"), str(e.get("name")))
            for e in json.loads(text)["traceEvents"]]


def trace_intervals(path, names):
    """``{name: [(start ns, end ns)]}`` of the complete events of a Chrome
    trace whose name is in ``names`` or whose category is "kernel" (under
    the key "kernel"), on the Unix clock: kineto writes "ts" and "dur" in
    us after the event's "pid" and "tid", relative to the trace's
    ``baseTimeNanoseconds``."""
    with open(path) as fh:
        text = fh.read()
    base = re.search(r'"baseTimeNanoseconds":\s*(\d+)', text)
    base = int(base.group(1)) if base else 0

    def ns(us):
        whole, _, frac = us.partition(".")
        return int(whole) * 1000 + int((frac + "000")[:3])
    out = {}
    pattern = (r'"cat":\s*"([^"]*)",\s*"name":\s*"((?:[^"\\]|\\.)*)",'
               r'\s*"pid":[^,]*,\s*"tid":[^,]*,\s*"ts":\s*([0-9.]+),'
               r'\s*"dur":\s*([0-9.]+)')
    for m in re.finditer(pattern, text):
        cat, name, ts, dur = m.groups()
        key = "kernel" if cat == "kernel" else name
        if key == "kernel" or name in names:
            start = base + ns(ts)
            out.setdefault(key, []).append((start, start + ns(dur)))
    return out


def phase_profiling(dev, counts, record, tmp):
    """Phase 20: ``utils.profiling`` on the card. ``trace`` around phase
    6's ``solve_network`` cut to its first chunk (0.5 s: the host and
    device events of its few hundred steps already make a trace of
    millions of events) with one ``annotate`` span, and ``Timings`` over
    it and phase 7's member 0 cut alike (discrete: the rate
    pre-calculation): the trace must hold the span, the device events of
    the path's kernels and the program's spans, the report the
    reference's three sections; the traced solve must equal an untraced
    one bit for bit. The solve record (the ``annotate`` span its
    outermost) against the trace: every span starts within 50 us of its
    twin there (the spans are stamped on the profiler's clock), and every
    kernel starts inside the outermost span. The same traced solve with
    the recorder held off (an outermost span opened before the profiler
    starts records nothing) gives the cost of the spans."""
    import torch
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.utils.profiling import (Timings, annotate,
                                                    last_solve, span, trace)

    tf = CHUNK
    sd, rd, calc, conds, pars = build_problem(
        dev, tf=tf, linsolve="inv_fused", rhs_contraction="dd")
    sd7, rd7, calc7, conds7, pars7 = build_problem(
        dev, ts_update=TS_UPDATE, tf=tf, linsolve="inv_fused",
        rhs_contraction="dd")
    span_name = "chip_smoke.phase20"
    logdir = os.path.join(tmp, "trace")
    plain, plain_s = timed_run(lambda: solve_network(
        VariableODESolve(pars, conds[0], calc), sd, rd, device=dev))
    Timings.reset()
    Timings.enable(True)
    try:
        counts.reset()
        with trace(logdir) as path:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate(span_name):
                out = solve_network(VariableODESolve(pars, conds[0], calc),
                                    sd, rd, device=dev)
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        rec = last_solve()
        launches, syncs = counts.read()
        out7 = solve_network(VariableODESolve(pars7, conds7[0], calc7), sd7,
                             rd7, device=dev)
        rep = Timings.report(log=False)
    finally:
        Timings.enable(False)
        Timings.reset()
    with span("chip_smoke.phase20_spans_off"):
        with trace(os.path.join(tmp, "trace_off")):
            quiet, quiet_s = timed_run(lambda: solve_network(
                VariableODESolve(pars, conds[0], calc), sd, rd, device=dev))
    if not (out.sol.success and out7.sol.success):
        fail(f"phase 20: {out.sol.retcode}, {out7.sol.retcode}")
    if not (np.array_equal(out.sol.u, plain.sol.u)
            and np.array_equal(quiet.sol.u, plain.sol.u)):
        fail("phase 20: a traced solve differs from the untraced one")
    events = trace_events(path)
    device = {}
    # the factor's inverse is the f64 Gauss-Jordan kernel
    wanted = {"dd_contract": "dd_contract_kernel",
              "newton_solve": "newton_solve_kernel",
              "gj_inverse": "gj_inverse64_kernel"}
    for cat, name in events:
        if cat == "kernel":
            for k, kernel in wanted.items():
                if kernel in name:
                    device[k] = device.get(k, 0) + 1
    names = {name for _, name in events}
    spans = [name for _, name in events if name == span_name]
    if set(device) != {"dd_contract", "newton_solve", "gj_inverse"} or not spans:
        fail(f"phase 20: device events {device}, span events {len(spans)}")
    if not {"bdf.step", "host_sync.read"} <= names:
        fail("phase 20: the trace holds no bdf.step or host_sync.read span")
    if rec is None or rec.top.name != span_name:
        fail(f"phase 20: the solve record's outermost span is "
             f"{rec and rec.top.name}, not {span_name}")
    twins = trace_intervals(path, {s.name for s in rec.spans})
    offsets = []     # (|start offset|, |end offset|, name, ordinal)
    for name in {s.name for s in rec.spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in rec.spans
                      if s.name == name)
        theirs = sorted(twins.get(name, []))
        if len(mine) != len(theirs):
            fail(f"phase 20: {len(mine)} {name} spans, {len(theirs)} in "
                 f"the trace")
        offsets += [(abs(a[0] - b[0]), abs(a[1] - b[1]), name, i)
                    for i, (a, b) in enumerate(zip(mine, theirs))]
    offsets.sort(reverse=True)
    off_med = float(np.median([o[0] for o in offsets]))
    off_max = offsets[0][0]
    worst = ", ".join(f"{n} #{i} {a / 1e3:.1f} / {b / 1e3:.1f} us"
                      for a, b, n, i in offsets[:4])
    if off_max > 50_000:
        fail(f"phase 20: span starts {off_max / 1e3:.1f} us from their "
             f"twins in the trace (median {off_med / 1e3:.2f} us; largest "
             f"start / end offsets: {worst})")
    kernels = twins.get("kernel", [])
    outside = [a for a, _ in kernels
               if not rec.top.start_ns <= a <= rec.top.end_ns]
    if not kernels or outside:
        fail(f"phase 20: {len(outside)} of {len(kernels)} kernels start "
             f"outside the record's outermost span")
    sections = ("solve.calculator_setup", "solve.chunk_dispatch",
                "solve.rate_precalc")
    if not all(rep.get(s, {}).get("count", 0) >= 1 for s in sections):
        fail(f"phase 20: Timings report {rep}")
    require_launched(20, launches, ("dd_contract", "newton_solve",
                                    "gj_inverse"))
    steps = out.sol.stats["n_steps"]
    record("20", launches, steps)
    say(f"phase 20 profiling: phase 6 cut to tf {tf} s, {steps} steps, "
        f"traced {traced_s:.3f} s (spans held off, the next session: "
        f"{quiet_s:.3f} s; both without the trace's export) vs "
        f"untraced {plain_s:.3f} s (bit-equal); "
        f"trace {os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
        f"device events {device} (launches {launches}), span "
        f"{len(spans)}x; solve record {len(rec.spans)} spans, starts vs "
        f"their trace twins median {off_med / 1e3:.3f} us, largest "
        f"{off_max / 1e3:.3f} us (start / end: {worst}); {len(kernels)} "
        f"kernels inside its "
        f"outermost span; host syncs {syncs} by site "
        f"{rec.counters['host_sync.by_site']}; Timings "
        + "; ".join(f"{k} {v['count']}x {v['total_s']:.3f} s "
                    f"(self {v['self_s']:.3f})" for k, v in rep.items()))


# ---- phases 21-22: the examples and the tutorials ----
# the kernels every example and tutorial reaches with default parameters:
# "auto" resolves to the fused RHS and inv_gated (the Gauss-Jordan factor)
USER_PATH = ("fused_rhs", "gj_inverse", "grid_probe")


class StepCount:
    """Steps of every ``bdf_solve`` inside the ``with`` block: the sum over
    calls of the most steps a lane took (one device read a call)."""

    def __enter__(self):
        from kinetica_tpu_torch.ops import bdf
        self.bdf, self.orig, self.total = bdf, bdf.bdf_solve, 0

        def counted(*a, **k):
            res = self.orig(*a, **k)
            self.total += int(res.n_steps.max())
            return res
        bdf.bdf_solve = counted
        return self

    def __exit__(self, *exc):
        self.bdf.bdf_solve = self.orig


def _analysis_reference(_):
    """The analysis pipeline's run on the CPU (a worker's job): what phase
    21 holds the card's run to."""
    import torch
    from kinetica_tpu_torch.examples import analysis_pipeline
    torch.set_num_threads(2)
    with contextlib.redirect_stdout(io.StringIO()):
        out = analysis_pipeline.main(device="cpu")
    return _analysis_summary(out)


def _analysis_summary(out):
    return dict(ranking=[int(r) for r in out.scr.ranking()[:8]],
                ee=np.asarray(out.scr.ee), survivors=list(out.survivors),
                ST=np.asarray(out.sob.ST), S1=np.asarray(out.sob.S1),
                keep=list(out.red.reduction.keep_rids),
                error=float(out.red.error), refused=out.refused is not None,
                top4=[int(r) for r, _ in out.flux.top(4)])


def _pyrolysis_reference(job):
    """Member ``b`` of the pyrolysis sweep of ``batch`` ramps by scipy-BDF
    (a worker's job)."""
    from kinetica_tpu_torch.examples import pyrolysis_sweep
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_discrete_baseline)
    batch, b = job
    sd, rd, calc, pars, conds = pyrolysis_sweep.problem(batch, device="cpu")
    cs = conds[b]
    cs.solve_variable_conditions(pars)
    return scipy_bdf_discrete_baseline(
        sd, rd, calc, cs.get_profile("T"), pars.tspan, make_u0(sd, pars),
        pars.reltol, pars.abstol, cs.get_tstops())


def _network_of(res):
    from kinetica_tpu_torch.core.network import format_rxn
    sd, rd = res.sd, res.rd
    return ([sd.toStr[i] for i in range(sd.n)],
            [format_rxn(sd, rd, i) for i in range(rd.nr)])


def _gate_reference(em, sm, conds, pool):
    """Member 0 of the last gate against scipy-BDF, submitted to ``pool``."""
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    e, pars = em.gate_log[-1], sm.pars
    return e, pool.submit(_discrete_reference, (
        e["sd"], e["rd"], sm.calculator, conds[0].get_profile("T"),
        e["sol"].t, make_u0(e["sd"], pars), pars.reltol, pars.abstol,
        conds[0].get_tstops()))


def _levels(em):
    return [(t["n_species"], t["n_reactions"]) for t in em.timings]


def _level_times(em):
    return ", ".join(f"L{t['level']} explore_s {t['explore_s']} solve_s "
                     f"{t['solve_s']}" for t in em.timings)


def phase_examples(dev, counts, record, tmp, pool, card, names):
    """Phase 21: the examples ``names`` (of ``EXAMPLES``) through their
    ``main`` at the JAX examples' published sizes on the card (see the
    module docstring), their CPU references in ``pool``."""
    import torch

    refs = {}
    if "analysis_pipeline" in names:
        refs["analysis_pipeline"] = pool.submit(_analysis_reference, None)
    if "pyrolysis_sweep" in names:
        refs["pyrolysis_sweep"] = [pool.submit(_pyrolysis_reference, (32, b))
                                   for b in (0, 31)]
    totals = {}

    def run(name, fn):
        """``fn()`` with the counts set to 0 just before it and read just
        after; the example's own output printed with its name."""
        counts.reset()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with StepCount() as steps, contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, syncs = counts.read()
        for line in buf.getvalue().splitlines():
            say(f"  {name} | {line}")
        require_launched(f"21 {name}", launches, USER_PATH)
        record(f"21 {name}", launches, max(steps.total, 1))
        totals[name] = wall
        per_step = {k: round(v / max(steps.total, 1), 4)
                    for k, v in launches.items()}
        return out, (f"{wall:.2f} s, {steps.total} steps (bdf_solve calls, "
                     f"most steps a lane each), launches {launches} "
                     f"({per_step} a step), host syncs {syncs}")

    for name in names:
        EXAMPLES[name](run, dev, tmp, pool, refs.get(name), card)
    say(f"phase 21 examples: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in totals.items()) + f" [{card}]")


def _example_getting_started(run, dev, tmp, pool, _ref, card):
    """Phase 21's getting_started: DirectExplore over the mock CDE, 500 ->
    1200 K."""
    from kinetica_tpu_torch.analysis.io import load_output
    from kinetica_tpu_torch.examples import getting_started
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing import example_records as rec
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_baseline
    from kinetica_tpu_torch.testing.explore_config import UniformArrhenius

    out, cost = run("getting_started", lambda: getting_started.main(
        workdir=os.path.join(tmp, "getting_started"), device=dev))
    res = out.res
    if _network_of(res) != (rec.GETTING_STARTED["species"],
                            rec.GETTING_STARTED["reactions"]):
        fail(f"phase 21 getting_started: network {_network_of(res)}, the "
             "record pinned from the JAX package's run (held on the CPU by "
             "tests/test_torch_examples_explore.py) differs")
    _, ref = scipy_bdf_baseline(
        res.sd, res.rd, UniformArrhenius(device="cpu"),
        res.conditions.get_profile("T"), res.pars.tspan,
        make_u0(res.sd, res.pars), res.pars.reltol, res.pars.abstol,
        best_of=1)
    err = final_err(res.sol.u[-1], ref)
    back = load_output(out.results)
    if not (res.sol.success and err <= 1e-6
            and np.array_equal(back.sol.u, res.sol.u)):
        fail(f"phase 21 getting_started: {res.sol.retcode}, vs scipy-BDF "
             f"{err:.3e} (> 1e-6?), results.npz loads back "
             f"{np.array_equal(back.sol.u, res.sol.u)}")
    say(f"phase 21 getting_started: {res.sd.n} sp / {res.rd.nr} rxn = the "
        f"record; final state vs scipy-BDF {err:.3e} (<= 1e-6); results.npz "
        f"loads back bit for bit; {cost} [{card}]")


def _example_pyrolysis_sweep(run, dev, tmp, pool, py_refs, card):
    """Phase 21's pyrolysis_sweep: nc=16, B=32, solved twice (the second
    timed)."""
    from kinetica_tpu_torch.examples import pyrolysis_sweep

    out, cost = run("pyrolysis_sweep", lambda: pyrolysis_sweep.main(
        device=dev))
    ens = out.ens
    refs = np.stack([f.result() for f in py_refs])
    err = mole_err(ens.u[[0, 31], -1], refs)
    steps = np.asarray(ens.stats["n_steps"])
    if not (ens.success and out.first.success and err <= 1e-6):
        fail(f"phase 21 pyrolysis_sweep: success {ens.success}, members 0 "
             f"and 31 vs scipy-BDF {err:.3e} (> 1e-6?)")
    say(f"phase 21 pyrolysis_sweep: {out.sd.n} sp / {out.rd.nr} rxn, B=32: "
        f"both solves all DONE; members 0/31 vs scipy-BDF {err:.3e} (<= "
        f"1e-6); second solve {out.sweep_s:.3f} s, "
        f"{out.sweep_s * 1e3 / 32:.2f} ms/profile, steps max/median "
        f"{int(steps.max())}/{int(np.median(steps))}, "
        f"{out.sweep_s * 1e3 / steps.max():.3f} ms/step; first solve (kernel "
        f"build included) {out.first_s:.3f} s; {cost} [{card}]")


def _example_analysis_pipeline(run, dev, tmp, pool, ap_ref, card):
    """Phase 21's analysis_pipeline: nc=6 at 1100 K, against the CPU run."""
    from kinetica_tpu_torch.examples import analysis_pipeline

    out, cost = run("analysis_pipeline", lambda: analysis_pipeline.main(
        device=dev))
    got = _analysis_summary(out)
    t1 = time.perf_counter()
    cpu = ap_ref.result()
    wait_s = time.perf_counter() - t1
    d_ee = float(np.abs(got["ee"] - cpu["ee"]).max() / np.abs(cpu["ee"]).max())
    d_st = float(np.abs(got["ST"] - cpu["ST"]).max())
    d_s1 = float(np.abs(got["S1"] - cpu["S1"]).max())
    same = all(got[k] == cpu[k] for k in ("ranking", "survivors", "keep",
                                          "top4"))
    if not (same and d_ee <= 1e-6 and d_st <= 1e-6 and d_s1 <= 1e-6
            and got["error"] <= 1e-3 and got["refused"]):
        fail(f"phase 21 analysis_pipeline: card {got} vs CPU {cpu}; "
             f"elementary effects {d_ee:.3e} of max|ee|, ST {d_st:.3e}, S1 "
             f"{d_s1:.3e} (<= 1e-6?)")
    say(f"phase 21 analysis_pipeline: {out.rd.nr} rxn / {out.sd.n} sp: Morris "
        f"top 8 {got['ranking']} = the CPU run's, effects within {d_ee:.3e} "
        f"of max|ee|; Sobol survivors equal, ST within {d_st:.3e}, S1 "
        f"{d_s1:.3e} (<= 1e-6); DRGEP keeps {len(got['keep'])} of "
        f"{out.rd.nr} reactions = the CPU run's, validated error "
        f"{got['error']:.3e} (<= 1e-3); projected flux top 4 {got['top4']} = "
        f"the CPU run's; trapezoid attribution refused (ValueError); CPU run "
        f"waited {wait_s:.1f} s after the card's; {cost} [{card}]")


def _example_iterative_exploration(run, dev, tmp, pool, _ref, card):
    """Phase 21's iterative_exploration: 3 ramps, at most 4 levels."""
    from kinetica_tpu_torch.examples import iterative_exploration
    from kinetica_tpu_torch.testing import example_records as rec

    out, cost = run("iterative_exploration",
                    lambda: iterative_exploration.main(
                        workdir=os.path.join(tmp, "iterative_exploration"),
                        device=dev))
    ie_rec = rec.ITERATIVE_EXPLORATION
    if (_levels(out.em) != ie_rec["levels"]
            or _network_of(out.res) != (ie_rec["species"],
                                        ie_rec["reactions"])):
        fail(f"phase 21 iterative_exploration: levels {_levels(out.em)}, the "
             f"JAX package's record {ie_rec['levels']} (or the network "
             "differs)")
    e, fut = _gate_reference(out.em, out.sm, out.conditions_list, pool)
    err = mole_err(e["sol"].u[0], fut.result())
    if err > 1e-6:
        fail(f"phase 21 iterative_exploration: member 0 of the last gate vs "
             f"scipy-BDF {err:.3e} (> 1e-6)")
    say(f"phase 21 iterative_exploration: levels {_levels(out.em)} = the JAX "
        f"record, network equal; last gate member 0 vs scipy-BDF {err:.3e} "
        f"(<= 1e-6); {_level_times(out.em)}; {cost} [{card}]")


def _example_full_product(run, dev, tmp, pool, _ref, card):
    """Phase 21's full_product: 16 ramps, 3 levels, sweep, Morris, DRGEP at
    1e-3."""
    from kinetica_tpu_torch.examples import full_product
    from kinetica_tpu_torch.testing import example_records as rec

    def product():
        got = {}
        try:
            full_product.main(workdir=os.path.join(tmp, "full_product"),
                              device=dev, record=got)
            got["refused"] = None
        except ValueError as exc:
            got["refused"] = str(exc)
        return got

    got, cost = run("full_product", product)
    fp_rec = rec.FULL_PRODUCT
    if (_levels(got["em"]) != fp_rec["levels"]
            or _network_of(got["res"]) != (fp_rec["species"],
                                           fp_rec["reactions"])
            or got["target"] != fp_rec["target"]):
        fail(f"phase 21 full_product: levels {_levels(got['em'])} (the JAX "
             f"record {fp_rec['levels']}), target {got['target']!r} "
             f"({fp_rec['target']!r}), or the network differs")
    if not (got["ens"].success and np.all(np.isfinite(got["mres"].mu_star))):
        fail("phase 21 full_product: the sweep or the Morris screen failed")
    if got["refused"] is not None:
        # the JAX package raises this at the published settings (its record)
        if got["refused"] != fp_rec["drgep_refused"]:
            fail(f"phase 21 full_product: DRGEP raised {got['refused']!r}, "
                 f"the JAX package {fp_rec['drgep_refused']!r}")
        drgep = ("DRGEP raised the JAX package's own ValueError at tol 1e-3, "
                 "ladder and errors equal to its record: "
                 + got["refused"].split("Ladder: ")[1][:80] + "...")
    else:
        red = got["red"]
        if red.error > 1e-3:
            fail(f"phase 21 full_product: DRGEP error {red.error:.3e} > 1e-3")
        drgep = (f"DRGEP {len(red.reduction.keep_rids)} reactions, validated "
                 f"error {red.error:.3e} (<= 1e-3)")
    e, fut = _gate_reference(got["em"], got["sm"], got["conditions_list"],
                             pool)
    err = mole_err(e["sol"].u[0], fut.result())
    if err > 1e-6:
        fail(f"phase 21 full_product: member 0 of the last gate vs scipy-BDF "
             f"{err:.3e} (> 1e-6)")
    say(f"phase 21 full_product: levels {_levels(got['em'])} = the JAX "
        f"record, network and observable {got['target']!r} equal; last gate "
        f"member 0 vs scipy-BDF {err:.3e} (<= 1e-6); 16-profile sweep all "
        f"DONE; Morris mu* finite; {drgep}; stages "
        f"{[round(x, 2) for x in got['stage_s']]} s; {_level_times(got['em'])}"
        f"; {cost} [{card}]")


EXAMPLES = {"getting_started": _example_getting_started,
            "pyrolysis_sweep": _example_pyrolysis_sweep,
            "analysis_pipeline": _example_analysis_pipeline,
            "iterative_exploration": _example_iterative_exploration,
            "full_product": _example_full_product}


def _tutorials_job(tmp):
    """Phase 22's run in a process of its own (a worker's job, beside phases
    5-20): every Python block of ``docs/tutorials/*.md`` on the
    card, the package name the only change, each tutorial in a directory
    under ``tmp``. Without matplotlib the blocks that need it are left
    out; any other block that raises raises here with its name. Returns
    the launches, host syncs, steps, the blocks' seconds and what was not
    run."""
    import torch
    from kinetica_tpu_torch.testing.tutorials import (NAMESPACES, run_tutorial,
                                                      without_matplotlib)
    torch.set_num_threads(2)
    try:
        import matplotlib  # noqa: F401
        skip = {}
    except ImportError:
        skip = without_matplotlib()
    counts = Counts()
    counts.reset()
    lines, n_run = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StepCount() as steps:
        for name in sorted(NAMESPACES):
            wd = os.path.join(tmp, name[:-3])
            os.makedirs(wd)
            os.chdir(wd)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    _, log = run_tutorial(name, skip)
            except Exception as exc:
                raise RuntimeError(
                    f"{name}: {type(exc).__name__}: {exc}") from None
            n_run += sum(sec is not None for _, sec, _ in log)
            lines.append(f"{name} " + " ".join(
                f"[{i}] {'not run' if sec is None else f'{sec:.2f} s'}"
                for i, sec, _ in log))
    torch.cuda.synchronize()
    launches, syncs = counts.read()
    return dict(launches=launches, syncs=syncs, steps=steps.total,
                wall=time.perf_counter() - t0, n_run=n_run, lines=lines,
                n_tutorials=len(NAMESPACES),
                not_run=[f"{n}[block {i}] ({why})"
                         for (n, i), why in sorted(skip.items())])


def phase_tutorials(job, record, card):
    """Phase 22: the tutorials' blocks on the card, from ``job``, the future
    of :func:`_tutorials_job`; any block that raised fails the phase."""
    try:
        res = job.result()
    except Exception as exc:
        fail(f"phase 22 {exc}")
    require_launched(22, res["launches"], USER_PATH)
    record("22", res["launches"], max(res["steps"], 1))
    not_run = res["not_run"]
    say(f"phase 22 tutorials: {res['n_run']} blocks of {res['n_tutorials']} "
        f"tutorials ran on the card in {res['wall']:.1f} s in a process of "
        f"their own beside phases 5-20; not run: "
        f"{not_run or 'none'}"
        + (" (this machine has no matplotlib; "
           "tests/test_torch_docs_tutorials.py runs them on the CPU)"
           if not_run else "")
        + f"; {res['steps']} steps, launches {res['launches']}, host syncs "
        f"{res['syncs']} | " + " | ".join(res["lines"]) + f" [{card}]")


# phase 21's examples in two processes of about equal time on the card
EXAMPLE_GROUPS = (("pyrolysis_sweep", "getting_started",
                   "iterative_exploration"),
                  ("full_product", "analysis_pipeline"))


def _phases_job(job):
    """Phases in a process of their own, beside the main process's phases
    5-20 (a worker's job): ``("examples", names, ...)`` runs phase 21's
    ``names``, ``("sensitivities", None, ...)`` phases 11 and 14-16, each
    with its CPU references in a pool of its own. Their lines and their
    paths' launches go back to the main process, which prints and records
    them; a phase that fails prints its message here and raises."""
    import torch
    what, names, tmp, card = job
    lines, recorded, printer = [], [], globals()["say"]
    globals()["say"] = lines.append

    def record(phase, launches, steps):
        recorded.append((phase, launches, steps))

    dev = torch.device("cuda:0")
    counts = Counts()
    try:
        if what == "examples":
            with spawn_pool(2) as refs:
                phase_examples(dev, counts, record, tmp, refs, card, names)
        else:
            with spawn_pool(1) as refs:
                grad11 = phase_adjoint(dev, counts, record,
                                       refs.submit(_adjoint_reference, None))
            t0 = time.perf_counter()
            phase_sensitivity_static(dev, counts, record, grad11)
            phase_sensitivity_ramp(dev, counts, record)
            phase_screening(dev, counts, record, grad11)
            phase_analysis(dev, counts, record, tmp)
            say(f"phases 14-16: {time.perf_counter() - t0:.1f} s on this "
                f"card [{card}]")
    except SystemExit:
        for line in lines:      # what ran before the failure
            print(line, flush=True)
        raise RuntimeError(f"{what}: failed (the message above)") from None
    finally:
        globals()["say"] = printer
    return dict(lines=lines, recorded=recorded)


# phase 23b's limit on the steps max: 1.2 x the JAX package's 2909 on the
# TPU (its round-4 run of scripts/bench_longhorizon.py, B = 64)
LONG_HORIZON_STEPS = 3490

# phase 23: the port's measurement programs, each through its ``main`` as
# ``python -m kinetica_tpu_torch.scripts.<name>`` runs it, with its
# environment: (label, module, argv, env)
PROGRAMS = (
    ("23a", "bench", ["--repeats", "3"], {}),
    # the 1e5 s horizon cut to B = 8 of its 64 ramps (time budget)
    ("23b", "bench_longhorizon", [], {"KINETICA_BENCH_BATCH": "8"}),
    ("23c", "step_count_audit", [], {}),
)


def _program_job(job):
    """One measurement program in this worker process, alone on the card:
    its launches (counts set to 0 just before ``main``, read just after),
    standard output, result and wall time."""
    import importlib

    import torch
    label, name, argv, env = job
    mod = importlib.import_module(f"kinetica_tpu_torch.scripts.{name}")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    counts, out = Counts(), io.StringIO()
    try:
        counts.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, syncs = counts.read()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(result=result, stdout=out.getvalue(), launches=launches,
                syncs=syncs, wall=wall)


def phase_programs(record, card, crn):
    """Phase 23: the bench (23a), the 1e5 s horizon cut (23b) and
    the step-count audit at its three lanes (23c), one after another in a
    worker process that dies with this one, once every other phase has
    ended: each program on the card alone. A program whose own gate fails
    raises there and fails the phase."""
    res = {}
    with spawn_pool(1) as pool:
        futures = {label: pool.submit(_program_job, (label, name, argv, env))
                   for label, name, argv, env in PROGRAMS}
        for label, name, _, _ in PROGRAMS:
            try:
                res[label] = futures[label].result()
            except Exception as exc:
                fail(f"phase {label} ({name}): {type(exc).__name__}: {exc}")

    r = res["23a"]
    rec, ex = r["result"], r["result"]["extra"]
    lines = [ln for ln in r["stdout"].splitlines() if ln.strip()]
    if [json.loads(ln) for ln in lines] != [rec]:
        fail(f"phase 23a: the bench printed {lines}, not one JSON line")
    if not (ex["max_molefrac_err"] <= 1e-6 and ex["platform"] == "gpu"
            and ex["device"] == card and ex["batch"] == BATCH
            and ex["crn"] == crn):
        fail(f"phase 23a: {ex}")
    require_launched("23a", r["launches"], USER_PATH)
    sweeps = 1 + ex["repeats"]
    record("23a", r["launches"], ex["steps_max"] * sweeps)
    say(f"phase 23a bench (python -m kinetica_tpu_torch.scripts.bench "
        f"--repeats {ex['repeats']}): {ex['crn']}, B={ex['batch']}: "
        f"{ex['per_profile_ms']:.2f} ms/profile median (min "
        f"{ex['per_profile_ms_min']:.2f}, max {ex['per_profile_ms_max']:.2f}; "
        f"sweeps {', '.join(f'{t:.3f}' for t in ex['sweep_s'])} s), "
        f"{ex['ms_per_step']:.3f} ms/step, steps max/median "
        f"{ex['steps_max']}/{ex['steps_median']}, compile_s "
        f"{ex['compile_s']:.2f}, scipy-BDF one profile "
        f"{ex['cpu_baseline_s']:.3f} s ({rec['value']:.3f}x), member 0 vs "
        f"scipy-BDF {ex['max_molefrac_err']:.3e}; {r['wall']:.1f} s in all; "
        f"launches {r['launches']}, host syncs {r['syncs']} over "
        f"{sweeps} sweeps [{ex['device']}]")
    say("phase 23a JSON: " + lines[0])

    r = res["23b"]
    out = r["result"]
    if not (out["max_molefrac_err"] <= 1e-6 and out["batch"] == 8
            and out["tf"] == 1e5 and out["n_chunks"] == 40
            and out["carbon_drift"] <= 1e-6
            and out["steps_max"] <= LONG_HORIZON_STEPS):
        fail(f"phase 23b: {out} (steps max <= {LONG_HORIZON_STEPS}?)")
    require_launched("23b", r["launches"], USER_PATH)
    record("23b", r["launches"], 2 * out["steps_max"])
    say(f"phase 23b the 1e5 s horizon (bench_longhorizon) cut to B=8 "
        f"({out['n_chunks']} chunks): "
        f"{out['per_profile_ms']:.1f} ms/profile ({out['sweep_s']:.3f} s "
        f"sweep, first call {out['warm_s']:.1f} s), steps max/median/min "
        f"{out['steps_max']}/{out['steps_median']}/{out['steps_min']} (<= "
        f"{LONG_HORIZON_STEPS}), "
        f"corr(steps, ramp rate) {out['corr_steps_rate']:+.3f}, carbon drift "
        f"{out['carbon_drift']:.2e}, chunked scipy-BDF "
        f"{out['cpu_baseline_s']:.2f} s, member 0 vs it "
        f"{out['max_molefrac_err']:.3e}; {r['wall']:.1f} s in all; launches "
        f"{r['launches']}, host syncs {r['syncs']} [{card}] | "
        + " | ".join(r["stdout"].strip().splitlines()))

    r = res["23c"]
    rows = r["result"]
    if [row["rate"] for row in rows] != [40.0, 50.0, 60.0] or not all(
            row["ours"] > 0 and row["scipy"] > 0 for row in rows):
        fail(f"phase 23c: {rows}")
    require_launched("23c", r["launches"], USER_PATH)
    record("23c", r["launches"],
           sum(row["ours"] + row["rejected"] for row in rows))
    say(f"phase 23c step-count audit (step_count_audit on the card): "
        + "; ".join(f"{row['rate']:.0f} K/s ours {row['ours']} (+"
                    f"{row['rejected']} rejected), scipy-BDF {row['scipy']}, "
                    f"ratio {row['ratio']:.3f}" for row in rows)
        + f"; {r['wall']:.1f} s in all; launches {r['launches']}, host syncs "
        f"{r['syncs']} [{card}]")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    import_port()
    import kinetica_tpu_torch.precision as precision
    from kinetica_tpu_torch.models.mass_action import augment, build_mass_action
    from kinetica_tpu_torch.ops import cuda_build, gj_inverse, grid_probe
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    from kinetica_tpu_torch.ops.linalg import (_equilibrate, _inv_factor,
                                               _newton_matrix,
                                               newton_schulz_refine)
    from kinetica_tpu_torch.ops.newton_solve import (_device_plan,
                                                     fused_newton_solve,
                                                     fused_newton_solve_plain)
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_baseline, scipy_bdf_discrete_baseline)
    from kinetica_tpu_torch.testing.device_timing import (
        bound, dd_work, graph_ms, inverse_work, loop_ms, rhs_work, solve_work)
    from kinetica_tpu_torch.testing.device_timing import event_ms as cuda_ms
    from kinetica_tpu_torch.testing.kernel_cases import (
        GJ_EDGE_WIDTHS, NEWTON_EDGE_WIDTHS, gj_edge_cases, mid_ramp_jacobian,
        near_singular_newton, newton_check, newton_edge_cases,
        rhs_edge_network, rhs_rel_err)

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no output"
    precision.assert_precision_policy()
    say(f"phase 1 device: {kind} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32} f32 precision="
        f"{torch.get_float32_matmul_precision()}")

    # ---- phase 2: build all five kernels from the checkout's sources ----
    t0 = time.perf_counter()
    cuda_build.load_libraries(KERNELS)
    say(f"phase 2 built {len(KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (concurrent nvcc)")
    for name in KERNELS:
        info = cuda_build.build_info[name]
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        say(f"phase 2 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs) or 'cached'}")

    counts = Counts()
    sd, rd, calc, conditions, pars = build_problem(dev)
    net = build_mass_action(rd, sd.n, device=dev)
    rng = np.random.default_rng(2024)
    kernels = {}

    # ---- phase 3: fused RHS kernel vs its plain version, B=64 / nc=24 ----
    fused = FusedMassActionRHS(net.N, net.reac_slots, dev)
    u = 10.0 ** rng.uniform(-14, 0, (BATCH, sd.n))
    u[rng.random((BATCH, sd.n)) < 0.2] = 0.0
    u_t = torch.as_tensor(u, device=dev)
    u_aug = augment(u_t, net.delta).contiguous()
    k = calc(torch.as_tensor(rng.uniform(700.0, 1300.0, BATCH),
                             dtype=torch.float64, device=dev)).contiguous()
    du_k = fused(u_aug, k)
    torch.cuda.synchronize()
    du_p = fused.plain(u_aug, k)
    max_err1 = float((du_k - du_p).abs().max())
    rel1 = rhs_rel_err(fused, u_aug, k, du_k)
    if not rel1 <= 1e-12:
        fail(f"fused_rhs disagrees with its plain version: max |d| "
             f"{max_err1:.3e}, max |d| / sum|N r| {rel1:.3e}")
    # edge cases: an empty and a 700-entry species row, B = 1 and 64; the
    # contraction kernel must equal the fused RHS bit for bit there too
    N_e, slots_e, empty_e, _ = rhs_edge_network()
    fused_e = FusedMassActionRHS(N_e, slots_e, dev)
    dd_e = DDContraction(N_e, dev)
    edge1 = {}
    for b in (1, BATCH):
        ue = 10.0 ** rng.uniform(-14, 0, (b, fused_e.ns))
        ue_aug = augment(torch.as_tensor(ue, device=dev), net.delta).contiguous()
        ke = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (b, fused_e.nr)),
                             device=dev)
        du_e = fused_e(ue_aug, ke)
        re = (ke * ue_aug[:, fused_e._slots64].prod(dim=-1)).contiguous()
        same = bool(torch.equal(dd_e(re), du_e))
        edge1[b] = rhs_rel_err(fused_e, ue_aug, ke, du_e)
        if not (edge1[b] <= 1e-12 and same
                and bool((du_e[:, empty_e] == 0).all())):
            fail(f"fused_rhs edge network B={b}: max |d| / sum|N r| "
                 f"{edge1[b]:.3e}, dd_contract equal {same}")
    ms1 = cuda_ms(lambda: fused(u_aug, k))
    g1 = graph_ms(lambda: fused(u_aug, k))
    ms1p = cuda_ms(lambda: fused.plain(u_aug, k))
    b1, by1 = bound(*rhs_work(fused, BATCH), "f64")
    say(f"phase 3 fused_rhs: B={BATCH} nr={rd.nr} ns={sd.n}: max |d| "
        f"{max_err1:.3e} (max |du| {float(du_p.abs().max()):.3e}), max |d| / "
        f"sum|N r| {rel1:.3e} (<= 1e-12); edge network (empty row, 700-entry "
        f"row) B=1 {edge1[1]:.3e}, B={BATCH} {edge1[BATCH]:.3e}, dd_contract "
        f"equal; kernel {ms1:.4f} ms, graph {g1:.5f} ms, plain {ms1p:.4f} ms, "
        f"bound {b1:.5f} ms ({by1}), no single library call")
    kernels["fused_rhs"] = {
        "name": "fused_rhs", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/fused_rhs.cu",
        "replaces": "kinetica_tpu/ops/pallas_matmul.py:384",
        "max_abs_err": max_err1, "max_rel_err": rel1, "ms": ms1,
        "graph_ms": g1, "plain_ms": ms1p, "bound_ms": b1, "bound_by": by1,
        "library_ms": None, "library_call": "no single call (gather, "
        "product and contraction)"}

    # ---- phase 4: Gauss-Jordan kernel vs its plain version, B=64 / n=73 ----
    # Newton matrices I - cJ from the nc=24 f32 Jacobian at the mid-ramp
    # state of member 0 (scipy-BDF to t = 7 s); c spread over the range in
    # which a bare f32 inverse is accurate (no Newton-Schulz needed), plus
    # one exactly singular member. The Newton factor inverts the
    # f32-equilibrated matrix in f64 (gj_inverse64_kernel: the kernels
    # line's "gj_inverse"); the f32 kernel ("gj_inverse_f32") is off the
    # main path, the witness that the elimination is the JAX kernel's
    u0 = make_u0(sd, pars)
    prof0 = conditions[0].get_profile("T")
    J = mid_ramp_jacobian(N_CARBONS, dev, TF)
    c = torch.as_tensor(np.logspace(-11, -5.5, BATCH), device=dev)
    JB = J.expand(BATCH, -1, -1).contiguous()
    As32, _, _ = _equilibrate(_newton_matrix(JB, c))
    As32 = As32.contiguous()
    As32[BATCH - 1, :, 5] = 0.0                                # singular
    A128_32 = (torch.eye(128, device=dev) + torch.as_tensor(
        rng.standard_normal((BATCH, 128, 128)) / (2 * 128 ** 0.5),
        device=dev).float()).contiguous()
    for dt, key in ((torch.float64, "gj_inverse"),
                    (torch.float32, "gj_inverse_f32")):
        kind, size = ("f64", 8) if dt == torch.float64 else ("f32", 4)
        As = As32.to(dt)
        M_k = gj_inverse.gj_inverse(As)
        torch.cuda.synchronize()
        M_p = gj_inverse.gj_inverse_plain(As)
        d = (M_k.double() - M_p.double())
        rel = d.norm(dim=(1, 2)) / M_p.double().norm(dim=(1, 2))
        resid = (torch.eye(sd.n, dtype=torch.float64, device=dev)
                 - As.double() @ M_k.double()).abs().amax(dim=(1, 2))[:-1]
        max_err2 = float(d[:-1].abs().max())                 # non-singular
        # the kernel rounds as the plain version does: count what differs
        # (0 on every case, the edge cases' near-singular members included)
        n_diff2 = int((M_k != M_p).sum())
        if not bool(torch.isfinite(M_k).all()):
            fail(f"gj_inverse {kind} gave non-finite values")
        if float(rel.max()) > 1e-5 or float(resid.max()) > 1e-3:
            fail(f"gj_inverse {kind}: max relative Frobenius "
                 f"{float(rel.max()):.3e}, max |I - A M| "
                 f"{float(resid.max()):.3e}")
        # edge cases at every tile edge: a pivot tie, a NaN column (the
        # member all NaN, no other touched), a singular member (finite)
        edge2 = {}
        for n in GJ_EDGE_WIDTHS:
            A_np, names = gj_edge_cases(n, seed=n)
            A_e = torch.as_tensor(A_np, device=dev).to(dt)
            M_e = gj_inverse.gj_inverse(A_e)
            torch.cuda.synchronize()
            M_ep = gj_inverse.gj_inverse_plain(A_e)
            nan = names.index("nan_column")
            keep = [i for i in range(len(names)) if i != nan]
            d_e = (M_e[keep].double() - M_ep[keep].double())
            edge2[n] = float((d_e.norm(dim=(1, 2))
                              / M_ep[keep].double().norm(dim=(1, 2))).max())
            n_diff2 += int((M_e[keep] != M_ep[keep]).sum())
            eye_e = torch.eye(n, dtype=torch.float64, device=dev)
            res_e = max(float((eye_e - A_e[i].double() @ M_e[i].double())
                              .abs().max())
                        for i in range(len(names))
                        if names[i] in ("random", "tie"))
            if not (edge2[n] <= 1e-5 and res_e <= 1e-3
                    and bool(torch.isfinite(M_e[keep]).all())
                    and bool(torch.isnan(M_e[nan]).all())):
                fail(f"gj_inverse {kind} edge cases n={n} ({names}): max rel "
                     f"Frobenius {edge2[n]:.3e}, max |I - A M| {res_e:.3e}, "
                     f"finite {bool(torch.isfinite(M_e[keep]).all())}, NaN "
                     f"member all NaN {bool(torch.isnan(M_e[nan]).all())}")
        if n_diff2:
            fail(f"gj_inverse {kind}: {n_diff2} entries differ from the plain "
                 "version (phase 4 and its edge cases)")
        ms2 = cuda_ms(lambda: gj_inverse.gj_inverse(As))
        g2 = graph_ms(lambda: gj_inverse.gj_inverse(As))
        ms2p = cuda_ms(lambda: gj_inverse.gj_inverse_plain(As), n=5, warm=1)
        lib2 = loop_ms(lambda: torch.linalg.inv_ex(As)[0])
        b2, by2 = bound(*inverse_work(BATCH, sd.n, size), kind)
        A128 = A128_32.to(dt)
        g2_128 = graph_ms(lambda: gj_inverse.gj_inverse(A128))
        lib2_128 = loop_ms(lambda: torch.linalg.inv_ex(A128)[0])
        b2_128, by2_128 = bound(*inverse_work(BATCH, 128, size), kind)
        say(f"phase 4 gj_inverse {kind}: B={BATCH} n={sd.n}: max rel "
            f"Frobenius {float(rel.max()):.3e} (<= 1e-5), max |d| "
            f"{max_err2:.3e} (max |M| {float(M_p[:-1].abs().max()):.3e}, "
            f"non-singular), max |I - A M| {float(resid.max()):.3e} (<= 1e-3, "
            f"non-singular), singular member finite; edge cases (tie, NaN "
            f"column, singular, near-singular) max rel Frobenius "
            + ", ".join(f"n={n} {e:.2e}" for n, e in edge2.items())
            + f" (<= 1e-5); {n_diff2} entries differ from the plain version "
            f"in all; kernel {ms2:.4f} ms, graph {g2:.5f} ms, plain "
            f"{ms2p:.4f} ms, torch.linalg.inv_ex {lib2:.5f} ms, bound "
            f"{b2:.5f} ms ({by2}) | n=128: graph {g2_128:.5f} ms, "
            f"torch.linalg.inv_ex {lib2_128:.5f} ms, bound {b2_128:.5f} ms "
            f"({by2_128})")
        kernels[key] = {
            "name": key, "route": "cuda", "dtype": kind,
            "source": "kinetica_tpu_torch/csrc/gj_inverse.cu",
            "replaces": "kinetica_tpu/ops/pallas_linalg.py:71",
            "max_abs_err": max_err2, "max_rel_err": float(rel.max()),
            "entries_differing_from_plain": n_diff2, "ms": ms2,
            "graph_ms": g2, "plain_ms": ms2p, "bound_ms": b2, "bound_by": by2,
            "library_ms": lib2, "library_call": LIBRARY_INV,
            "graph_ms_n128": g2_128, "library_ms_n128": lib2_128,
            "bound_ms_n128": b2_128, "bound_by_n128": by2_128}

    # ---- phase 4b: the widest shapes of the RHS and Gauss-Jordan kernels ----
    # off the main path: the fused RHS launch that raises the dynamic
    # shared-memory limit (nr = 8000 reactions, 64.6 KB of rates), and the
    # Gauss-Jordan kernel at its full 128-wide tile, in f64 and f32
    nr_w = 8000
    N_w = rng.integers(-2, 3, (nr_w, sd.n)).astype(np.float64)
    slots_w = rng.integers(0, sd.n + 1, (nr_w, 2))
    wide = FusedMassActionRHS(N_w, slots_w, dev)
    k_w = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (BATCH, nr_w)), device=dev)
    r_w = k_w * u_aug[:, torch.as_tensor(slots_w, device=dev)].prod(dim=-1)
    bound_w = r_w.abs() @ torch.as_tensor(np.abs(N_w), device=dev)
    rel_w1 = float(((wide(u_aug, k_w) - wide.plain(u_aug, k_w)).abs()
                    / bound_w.clamp_min(1e-300)).max())
    A_w32 = (torch.eye(128, device=dev) + torch.as_tensor(
        rng.standard_normal((8, 128, 128)) / 128 ** 0.5, device=dev).float())
    rel_w2, diff_w2, near = {}, {}, {}
    for dt in (torch.float64, torch.float32):
        kind = "f64" if dt == torch.float64 else "f32"
        A_w = A_w32.to(dt)
        M_w, M_wp = gj_inverse.gj_inverse(A_w), gj_inverse.gj_inverse_plain(A_w)
        rel_w2[kind] = float(((M_w - M_wp).double().norm(dim=(1, 2))
                              / M_wp.double().norm(dim=(1, 2))).max())
        diff_w2[kind] = int((M_w != M_wp).sum())
        # near-singular Newton matrices (the CPU tests' construction), where
        # the row exchange's arithmetic decides whether a pivot cancels
        for n_s, b_s in ((19, 48), (sd.n, 48), (128, 8)):
            A_s = torch.as_tensor(near_singular_newton(b_s, n_s, seed=1),
                                  device=dev).to(dt)
            M_s = gj_inverse.gj_inverse(A_s)
            torch.cuda.synchronize()
            M_sp = gj_inverse.gj_inverse_plain(A_s)
            near[f"{kind} n={n_s}"] = (int((M_s != M_sp).sum()),
                                       float(M_s.abs().amax()),
                                       bool(M_s.isfinite().all()))
    if not (rel_w1 <= 1e-12 and max(rel_w2.values()) <= 1e-5
            and not any(diff_w2.values())
            and all(d == 0 and fin for d, _, fin in near.values())):
        fail(f"wide shapes: fused_rhs max |d| / sum|N r| {rel_w1:.3e}, "
             f"gj_inverse max rel Frobenius {rel_w2}, entries differing "
             f"{diff_w2}; near-singular (differing, max|M|, finite) {near}")
    say(f"phase 4b wide shapes: fused_rhs nr={nr_w} max |d| / sum|N r| "
        f"{rel_w1:.3e} (<= 1e-12); gj_inverse n=128 "
        + ", ".join(f"{k} max rel Frobenius {rel_w2[k]:.3e} (<= 1e-5), "
                    f"{diff_w2[k]} entries differ" for k in rel_w2)
        + "; near-singular Newton matrices: "
        + ", ".join(f"{k} {d} entries differ (max|M| {mx:.4e})"
                    for k, (d, mx, _) in near.items()))

    # ---- phase 4c: contraction kernel vs its plain version ----
    # the rates of phase 3; the kernel must also equal the fused RHS bit
    # for bit (same CSR rows, same order, same rates)
    dd = DDContraction(net.N, dev)
    r_c = net.rates(u_t, k).contiguous()
    du_dd = dd(r_c)
    torch.cuda.synchronize()
    du_ddp = dd.plain(r_c)
    bound_c = r_c.abs() @ net.N.abs()
    err_c = (du_dd - du_ddp).abs()
    max_err3 = float(err_c.max())
    rel3 = float((err_c / bound_c.clamp_min(1e-300)).max())
    n_diff = int((du_dd != du_k).sum())
    dd_w = DDContraction(N_w, dev)
    r_w = r_w.contiguous()
    rel3_w = float(((dd_w(r_w) - dd_w.plain(r_w)).abs()
                    / bound_w.clamp_min(1e-300)).max())
    if not (rel3 <= 1e-12 and rel3_w <= 1e-12) or n_diff:
        fail(f"dd_contract: max |d| / sum|N r| {rel3:.3e} (nr={rd.nr}), "
             f"{rel3_w:.3e} (nr={nr_w}); {n_diff} entries differ from fused_rhs")
    ms3 = cuda_ms(lambda: dd(r_c))
    g3 = graph_ms(lambda: dd(r_c))
    ms3p = cuda_ms(lambda: dd.plain(r_c))
    lib3 = graph_ms(lambda: r_c @ net.N)
    b3, by3 = bound(*dd_work(dd, BATCH), "f64")
    say(f"phase 4c dd_contract: B={BATCH} nr={rd.nr} ns={sd.n}: max |d| "
        f"{max_err3:.3e}, max |d| / sum|N r| {rel3:.3e} (<= 1e-12), equal to "
        f"fused_rhs bit for bit; nr={nr_w}: {rel3_w:.3e} (<= 1e-12); kernel "
        f"{ms3:.4f} ms, graph {g3:.5f} ms, plain {ms3p:.4f} ms, r @ N (dense "
        f"f64) {lib3:.5f} ms, bound {b3:.5f} ms ({by3})")
    kernels["dd_contract"] = {
        "name": "dd_contract", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/dd_contract.cu",
        "replaces": "kinetica_tpu/ops/pallas_matmul.py:103",
        "max_abs_err": max_err3, "max_rel_err": rel3, "ms": ms3,
        "graph_ms": g3, "plain_ms": ms3p, "bound_ms": b3, "bound_by": by3,
        "library_ms": lib3, "library_call": "r @ N (dense f64), graph_ms"}

    # ---- phase 4d: Newton-solve kernel vs its plain version ----
    # the Newton matrices of phase 4 (without the singular member), M from
    # the main path's factor (equilibrate, Gauss-Jordan, Newton-Schulz,
    # scales folded); lane STALE's M built at a stale 1.2 c, which leaves
    # it far from converged after 4 sweeps (c |J| ~ 7e4): it is held only
    # to its plain version
    STALE = BATCH // 2
    A4 = _newton_matrix(JB, c)
    M4 = _inv_factor(A4).contiguous()
    M4[STALE] = _inv_factor(_newton_matrix(JB[STALE:STALE + 1],
                                           1.2 * c[STALE:STALE + 1]))[0]
    b4 = torch.as_tensor(rng.standard_normal((BATCH, sd.n)), device=dev)
    dy_k = fused_newton_solve(M4, JB, b4, c)
    torch.cuda.synchronize()
    dy_p = fused_newton_solve_plain(M4, JB, b4, c)
    A64 = (torch.eye(sd.n, dtype=torch.float64, device=dev)
           - c[:, None, None] * JB.double())

    def solve_checks(dy, dyp, A, b):
        lane = ((dy - dyp).abs().amax(dim=1)
                / dyp.abs().amax(dim=1).clamp_min(1e-300))
        res = ((b - (A @ dy[..., None])[..., 0]).norm(dim=1) / b.norm(dim=1))
        return float((dy - dyp).abs().max()), float(lane.max()), res

    max_err4, lane4, res4 = solve_checks(dy_k, dy_p, A64, b4)
    # n = 128: random J (rows of mixed scale), M the f32 inverse of I - cJ
    n_w = 128
    J_w = torch.as_tensor(rng.standard_normal((8, n_w, n_w)), device=dev)
    c_w = torch.full((8,), 0.05, dtype=torch.float64, device=dev)
    J_w32 = J_w.float().contiguous()
    A_w64 = (torch.eye(n_w, dtype=torch.float64, device=dev)
             - c_w[:, None, None] * J_w32.double())
    M_w = torch.linalg.inv(A_w64).float().contiguous()
    b_w = torch.as_tensor(rng.standard_normal((8, n_w)), device=dev)
    _, lane4_w, res4_w = solve_checks(fused_newton_solve(M_w, J_w32, b_w, c_w),
                                      fused_newton_solve_plain(M_w, J_w32, b_w,
                                                               c_w),
                                      A_w64, b_w)
    fresh = torch.arange(BATCH, device=dev) != STALE
    res4_f, res4_s = float(res4[fresh].max()), float(res4[STALE])
    if not (lane4 <= 1e-5 and lane4_w <= 1e-5 and res4_f <= 1e-4
            and float(res4_w.max()) <= 1e-4):
        fail(f"newton_solve: per-lane max |d| / max|dy| {lane4:.3e} (n=73), "
             f"{lane4_w:.3e} (n=128); max residual {res4_f:.3e} (n=73), "
             f"stale lane {res4_s:.3e}, {float(res4_w.max()):.3e} (n=128)")
    # edge cases (kernel_cases.newton_edge_cases at n = 1, 31, 32, 33, 73,
    # 181: b = 0, a NaN lane, a stale lane that takes every sweep; B = 4, 1
    # and 0), and on them and on the systems above, every cluster size the
    # card takes equal bit for bit to the planned one
    cases4 = {f"n={sd.n} B={BATCH}": (M4, JB, b4, c, None)}
    for n in NEWTON_EDGE_WIDTHS:
        *arrays, names = newton_edge_cases(n, seed=n)
        M_e, J_e, b_e, c_e = (torch.as_tensor(x, device=dev) for x in arrays)
        for B_e in (len(names), 1, 0):
            cases4[f"edge n={n} B={B_e}"] = (M_e[:B_e], J_e[:B_e], b_e[:B_e],
                                             c_e[:B_e], names[:B_e])
    edge4, sizes4 = 0.0, set()
    for key, case in cases4.items():
        res = newton_check(*case)
        if case[2].shape[0] == 0:
            if not res["shape_ok"]:
                fail(f"newton_solve {key}: wrong output shape")
            continue
        sizes4 |= set(res["differing"])
        if not (res["lane_rel"] <= 1e-5 and res["finite"]
                and res["nan_lanes_nan"]) or any(res["differing"].values()):
            fail(f"newton_solve {key}: {res}")
        edge4 = max(edge4, res["lane_rel"])
    ms4 = cuda_ms(lambda: fused_newton_solve(M4, JB, b4, c))
    g4 = graph_ms(lambda: fused_newton_solve(M4, JB, b4, c))
    ms4p = cuda_ms(lambda: fused_newton_solve_plain(M4, JB, b4, c))
    b4_ms, by4 = bound(*solve_work(BATCH, sd.n), "f32")
    # B = 1 (the single solve of phase 6): the last, freshly factored lane
    one4 = [x[BATCH - 1:].contiguous() for x in (M4, JB, b4, c)]
    ms4_1 = cuda_ms(lambda: fused_newton_solve(*one4))
    g4_1 = graph_ms(lambda: fused_newton_solve(*one4))
    ms4p_1 = cuda_ms(lambda: fused_newton_solve_plain(*one4))
    b4_1, by4_1 = bound(*solve_work(1, sd.n), "f32")
    plan4 = {f"n{sd.n}_b{BATCH}": _device_plan(sd.n, BATCH, dev),
             f"n{sd.n}_b1": _device_plan(sd.n, 1, dev)}
    say(f"phase 4d newton_solve: B={BATCH} n={sd.n}: per-lane max |d| / "
        f"max|dy| {lane4:.3e} (<= 1e-5), max |b - A dy| / |b| {res4_f:.3e} "
        f"(<= 1e-4; lane {STALE}, M at 1.2 c = {float(c[STALE]):.2e}, "
        f"not bounded: {res4_s:.3e}); n=128: {lane4_w:.3e}, residual "
        f"{float(res4_w.max()):.3e}; edge cases (b = 0, NaN lane, stale "
        f"lane; n = {', '.join(map(str, NEWTON_EDGE_WIDTHS))}; B = 4, 1, 0) "
        f"max {edge4:.3e} (<= 1e-5); cluster sizes {sorted(sizes4)} equal "
        f"bit for bit; kernel {ms4:.4f} ms, graph {g4:.5f} ms, plain "
        f"{ms4p:.4f} ms, bound {b4_ms:.5f} ms ({by4}), no single library "
        f"call | B=1: graph {g4_1:.5f} ms, kernel {ms4_1:.4f} ms, plain "
        f"{ms4p_1:.4f} ms, bound {b4_1:.6f} ms ({by4_1}); clusters {plan4}")
    kernels["newton_solve"] = {
        "name": "newton_solve", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/newton_solve.cu",
        "replaces": "kinetica_tpu/ops/pallas_linalg.py:283",
        "max_abs_err": max_err4, "max_rel_err": lane4, "ms": ms4,
        "graph_ms": g4, "plain_ms": ms4p, "bound_ms": b4_ms, "bound_by": by4,
        "library_ms": None, "library_call": "no single call (inverse "
        "application, f64-residual refinement, per-lane stop)",
        "ms_b1": ms4_1, "graph_ms_b1": g4_1, "plain_ms_b1": ms4p_1,
        "bound_ms_b1": b4_1, "bound_by_b1": by4_1, "cluster_plan": plan4}

    # ---- phase 4e: the grid probe ----
    x = torch.ones(grid_probe.ROWS, grid_probe.COLS, device=dev)
    out_k = grid_probe.grid_probe(x)
    torch.cuda.synchronize()
    err5 = float((out_k - grid_probe.grid_probe_plain(x)).abs().max())
    if not (err5 <= grid_probe.TOL and grid_probe.passed):
        fail(f"grid probe: |kernel - plain| {err5:.3e}, passed="
             f"{grid_probe.passed}")
    ms5 = cuda_ms(lambda: grid_probe.grid_probe(x))
    g5 = graph_ms(lambda: grid_probe.grid_probe(x))
    ms5p = cuda_ms(lambda: grid_probe.grid_probe_plain(x))
    # x read, the zeroed output written, BLOCKS f32 additions an element
    b5, by5 = bound(2 * x.numel() * 4, grid_probe.BLOCKS * x.numel(), "f32")
    say(f"phase 4e grid_probe: {grid_probe.BLOCKS} blocks into one "
        f"({grid_probe.ROWS}, {grid_probe.COLS}) output: every element "
        f"{float(out_k.min()):.1f}, |kernel - plain| {err5:.1e} (<= "
        f"{grid_probe.TOL}); passed at start-up; kernel {ms5:.4f} ms, graph "
        f"{g5:.5f} ms, plain {ms5p:.4f} ms, bound {b5:.6f} ms ({by5}), no "
        f"single library call")
    kernels["grid_probe"] = {
        "name": "grid_probe", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/grid_probe.cu",
        "replaces": "kinetica_tpu/ops/pallas_matmul.py:686",
        "max_abs_err": err5, "ms": ms5, "graph_ms": g5, "plain_ms": ms5p,
        "bound_ms": b5, "bound_by": by5, "library_ms": None,
        "library_call": "no single call (a multi-block accumulation probe)"}

    # ---- phase 4f: the multi-tile widths, n = 181 (B=64) and 512 (B=8) ----
    # n = 181: Newton matrices of the nc=60 f32 Jacobian at member 0's
    # mid-ramp state, over phase 4's c range; n = 512: random J at c = 0.025
    # (phase 4d's n = 128 systems, c scaled by sqrt(128 / n)), as no network
    # of the repo has 512 species. schur_inverse runs the Gauss-Jordan
    # kernel on its diagonal blocks (128 + 53; (128 + 128) + (128 + 128))
    sd60, rd60, calc60, conds60, pars60 = build_problem(
        dev, n_carbons=WIDE_CARBONS)
    net60 = build_mass_action(rd60, sd60.n, device=dev)
    u0_60 = make_u0(sd60, pars60)
    prof60 = conds60[0].get_profile("T")
    t0 = time.perf_counter()
    J60 = mid_ramp_jacobian(WIDE_CARBONS, dev, TF)
    mid60_s = time.perf_counter() - t0
    J60B = J60.expand(BATCH, -1, -1).contiguous()
    A181 = _newton_matrix(J60B, c)
    n_w = WIDE_N
    J512 = torch.as_tensor(rng.standard_normal((8, n_w, n_w)),
                           device=dev).float().contiguous()
    c512 = torch.full((8,), 0.025, dtype=torch.float64, device=dev)
    A512 = _newton_matrix(J512, c512)
    wide = {}
    for n, A_n in ((sd60.n, A181), (n_w, A512)):
        # in f64, as the Newton factor inverts (rounded to f32 before
        # Newton-Schulz), and in f32
        As_n32 = _equilibrate(A_n)[0].contiguous()
        As_n = As_n32.double()
        res_s, rel_s, diff_s = {}, {}, {}
        for kind, A_k in (("f64", As_n), ("f32", As_n32)):
            M_k = gj_inverse.schur_inverse(A_k)
            torch.cuda.synchronize()
            M_p = gj_inverse.schur_inverse_plain(A_k)
            rel_s[kind] = float(((M_k - M_p).double().norm(dim=(1, 2))
                                 / M_p.double().norm(dim=(1, 2))).max())
            diff_s[kind] = int((M_k != M_p).sum())
            M_r, _ = newton_schulz_refine(M_k.float(), As_n32)
            eye = torch.eye(n, dtype=torch.float64, device=dev)
            res_s[kind] = float((eye - As_n @ M_r.double()).abs().max())
            if not (bool(torch.isfinite(M_k).all()) and rel_s[kind] <= 1e-5
                    and res_s[kind] <= 1e-3 and diff_s[kind] == 0):
                fail(f"schur_inverse {kind} n={n}: max rel Frobenius "
                     f"{rel_s[kind]:.3e}, max |I - A M| after Newton-Schulz "
                     f"{res_s[kind]:.3e}, {diff_s[kind]} entries differ from "
                     "the plain version")
        ms_s = cuda_ms(lambda: gj_inverse.schur_inverse(As_n))
        g_s = graph_ms(lambda: gj_inverse.schur_inverse(As_n))
        g_s32 = graph_ms(lambda: gj_inverse.schur_inverse(As_n32))
        ms_sp = cuda_ms(lambda: gj_inverse.schur_inverse_plain(As_n), n=5,
                        warm=1)
        lib_s = loop_ms(lambda: torch.linalg.inv_ex(As_n)[0])
        b_s, by_s = bound(*inverse_work(A_n.shape[0], n, 8), "f64")
        # Newton solve: M the main path's factor of the same matrices
        M_f = _inv_factor(A_n).contiguous()
        J_n = J60B if n == sd60.n else J512
        c_n = c if n == sd60.n else c512
        b_n = torch.as_tensor(rng.standard_normal((A_n.shape[0], n)), device=dev)
        dy_k = fused_newton_solve(M_f, J_n, b_n, c_n)
        torch.cuda.synchronize()
        dy_p = fused_newton_solve_plain(M_f, J_n, b_n, c_n)
        A_n64 = eye - c_n[:, None, None] * J_n.double()
        _, lane_n, res_n = solve_checks(dy_k, dy_p, A_n64, b_n)
        sizes_n = newton_check(M_f, J_n, b_n, c_n)["differing"]
        if not (lane_n <= 1e-5 and float(res_n.max()) <= 1e-4) or any(
                sizes_n.values()):
            fail(f"newton_solve n={n}: per-lane max |d| / max|dy| "
                 f"{lane_n:.3e}, max residual {float(res_n.max()):.3e}, "
                 f"entries differing by cluster size {sizes_n}")
        ms_n = cuda_ms(lambda: fused_newton_solve(M_f, J_n, b_n, c_n))
        g_n = graph_ms(lambda: fused_newton_solve(M_f, J_n, b_n, c_n))
        ms_np = cuda_ms(lambda: fused_newton_solve_plain(M_f, J_n, b_n, c_n))
        b_n_ms, by_n = bound(*solve_work(A_n.shape[0], n), "f32")
        kernels["newton_solve"]["cluster_plan"][f"n{n}_b{A_n.shape[0]}"] = (
            _device_plan(n, A_n.shape[0], dev))
        one_n = ""
        if n == sd60.n:
            # B = 1 (the single solve of phase 9): the last lane
            one = [x[-1:].contiguous() for x in (M_f, J_n, b_n, c_n)]
            g_1 = graph_ms(lambda: fused_newton_solve(*one))
            b_1, by_1 = bound(*solve_work(1, n), "f32")
            kernels["newton_solve"].update({
                f"ms_n{n}_b1": cuda_ms(lambda: fused_newton_solve(*one)),
                f"graph_ms_n{n}_b1": g_1,
                f"plain_ms_n{n}_b1": cuda_ms(
                    lambda: fused_newton_solve_plain(*one)),
                f"bound_ms_n{n}_b1": b_1, f"bound_by_n{n}_b1": by_1})
            kernels["newton_solve"]["cluster_plan"][f"n{n}_b1"] = (
                _device_plan(n, 1, dev))
            one_n = f"; B=1 graph {g_1:.5f} ms, bound {b_1:.6f} ms ({by_1})"
        kernels["gj_inverse"].update({
            f"ms_n{n}": ms_s, f"graph_ms_n{n}": g_s, f"plain_ms_n{n}": ms_sp,
            f"library_ms_n{n}": lib_s, f"bound_ms_n{n}": b_s,
            f"bound_by_n{n}": by_s})
        kernels["gj_inverse_f32"][f"graph_ms_n{n}"] = g_s32
        kernels["newton_solve"].update({
            f"ms_n{n}": ms_n, f"graph_ms_n{n}": g_n, f"plain_ms_n{n}": ms_np,
            f"bound_ms_n{n}": b_n_ms, f"bound_by_n{n}": by_n})
        say(f"phase 4f n={n} B={A_n.shape[0]}: schur_inverse "
            + ", ".join(f"{k} max rel Frobenius {rel_s[k]:.3e} (<= 1e-5), "
                        f"{diff_s[k]} entries differ from the plain version, "
                        f"max |I - A M| after Newton-Schulz {res_s[k]:.3e} "
                        f"(<= 1e-3)" for k in rel_s)
            + f"; f64 kernel {ms_s:.4f} ms, graph {g_s:.5f} ms (f32 "
            f"{g_s32:.5f} ms), plain {ms_sp:.4f} ms, torch.linalg.inv_ex "
            f"{lib_s:.5f} ms, bound {b_s:.5f} ms ({by_s}) | newton_solve "
            f"per-lane max |d| / max|dy| {lane_n:.3e} (<= 1e-5), max |b - A dy|"
            f" / |b| {float(res_n.max()):.3e} (<= 1e-4), cluster sizes "
            f"{sorted(sizes_n)} equal bit for bit; kernel {ms_n:.4f} ms, "
            f"graph {g_n:.5f} ms, plain {ms_np:.4f} ms, bound {b_n_ms:.5f} ms "
            f"({by_n}){one_n}")
    # the block-Schur composition on near-singular Newton matrices (the
    # CPU tests' construction) at n = 181: every diagonal block
    # near-singular too
    A_ns32 = torch.as_tensor(near_singular_newton(8, sd60.n, seed=1),
                             device=dev)
    near_s = {}
    for kind, A_ns in (("f64", A_ns32.double()), ("f32", A_ns32)):
        M_ns = gj_inverse.schur_inverse(A_ns)
        torch.cuda.synchronize()
        M_nsp = gj_inverse.schur_inverse_plain(A_ns)
        near_s[kind] = (int((M_ns != M_nsp).sum()),
                        float(M_ns.abs().amax()), bool(M_ns.isfinite().all()))
    if not all(d == 0 and fin for d, _, fin in near_s.values()):
        fail(f"schur_inverse near-singular n={sd60.n} (entries differing "
             f"from the plain version, max|M|, finite): {near_s}")
    say(f"phase 4f near-singular Newton matrices n={sd60.n} B=8: "
        "schur_inverse "
        + ", ".join(f"{k} {d} entries differ from the plain version (max|M| "
                    f"{mx:.4e})" for k, (d, mx, _) in near_s.items()))
    # the fused RHS and the contraction at the nc=60 sweep's width (phase 8)
    fused60 = FusedMassActionRHS(net60.N, net60.reac_slots, dev)
    dd60 = DDContraction(net60.N, dev)
    u60 = 10.0 ** rng.uniform(-14, 0, (BATCH, sd60.n))
    u60_aug = augment(torch.as_tensor(u60, device=dev), net60.delta).contiguous()
    k60 = calc60(torch.as_tensor(rng.uniform(700.0, 1300.0, BATCH),
                                 dtype=torch.float64, device=dev)).contiguous()
    du60 = fused60(u60_aug, k60)
    rel60 = rhs_rel_err(fused60, u60_aug, k60, du60)
    r60 = net60.rates(torch.as_tensor(u60, device=dev), k60).contiguous()
    if not rel60 <= 1e-12 or not torch.equal(dd60(r60), du60):
        fail(f"fused_rhs nc={WIDE_CARBONS}: max |d| / sum|N r| {rel60:.3e}, "
             "or dd_contract differs from it")
    g60 = graph_ms(lambda: fused60(u60_aug, k60))
    b60, by60 = bound(*rhs_work(fused60, BATCH), "f64")
    g60d = graph_ms(lambda: dd60(r60))
    lib60d = graph_ms(lambda: r60 @ net60.N)
    b60d, by60d = bound(*dd_work(dd60, BATCH), "f64")
    kernels["fused_rhs"].update({
        f"graph_ms_nc{WIDE_CARBONS}": g60, f"bound_ms_nc{WIDE_CARBONS}": b60,
        f"bound_by_nc{WIDE_CARBONS}": by60})
    kernels["dd_contract"].update({
        f"graph_ms_nc{WIDE_CARBONS}": g60d,
        f"library_ms_nc{WIDE_CARBONS}": lib60d,
        f"bound_ms_nc{WIDE_CARBONS}": b60d, f"bound_by_nc{WIDE_CARBONS}": by60d})
    say(f"phase 4f nc={WIDE_CARBONS} B={BATCH} ({rd60.nr} rxn / {sd60.n} sp):"
        f" fused_rhs max |d| / sum|N r| {rel60:.3e} (<= 1e-12), dd_contract "
        f"equal bit for bit; fused_rhs graph {g60:.5f} ms, bound {b60:.5f} ms "
        f"({by60}); dd_contract graph {g60d:.5f} ms, r @ N (dense f64) "
        f"{lib60d:.5f} ms, bound {b60d:.5f} ms ({by60d})")
    # ---- phase 4g: the four forward-mode rules through the kernels ----
    t0 = time.perf_counter()
    phase_rules(dev, kernels, rng, {
        "As": _equilibrate(_newton_matrix(JB, c))[0].contiguous(),
        "As181": _equilibrate(A181)[0].contiguous(), "A4": A4,
        "newton": (M4, JB, b4, c), "dd": (dd, r_c),
        "fused": (fused, u_aug, k)})
    say(f"phase 4g: {time.perf_counter() - t0:.1f} s on this card")

    # the card's other processes, started once the kernels are timed and
    # run beside phases 5-20 of this one: phase 21's examples in two,
    # phase 22's tutorials, phases 11 and 14-16
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    side_t0 = time.perf_counter()
    children = spawn_pool(4)
    side = {}
    for sub in ("21-0", "21-1", "22", "16"):
        os.makedirs(os.path.join(work, sub))
    for i, names in enumerate(EXAMPLE_GROUPS):
        side[f"21 {', '.join(names)}"] = children.submit(_phases_job, (
            "examples", names, os.path.join(work, f"21-{i}"), card))
    side["22"] = children.submit(_tutorials_job, os.path.join(work, "22"))
    side["11, 14-16"] = children.submit(_phases_job, (
        "sensitivities", None, os.path.join(work, "16"), card))

    total = dict.fromkeys(KERNELS, 0)
    per_step = {kname: {} for kname in KERNELS}
    newton_step_ms = {}

    def newton_device(phase, launches, steps, graph_key):
        """The Newton-solve kernel's device ms per step on a path: its
        graph_ms at the path's shape times its launches per step."""
        newton_step_ms[phase] = (kernels["newton_solve"][graph_key]
                                 * launches["newton_solve"] / steps)
        return (f"; newton_solve device {newton_step_ms[phase]:.5f} ms/step "
                f"({graph_key} x launches/step)")

    def record(phase, launches, steps):
        """Add a path's launches; each kernel's launches per step there."""
        for kname in KERNELS:
            total[kname] += launches[kname]
            per_step[kname][phase] = launches[kname] / steps

    # ---- phase 5: the continuous sweep, warm-up then the counted run ----
    t0 = time.perf_counter()
    _, cpu_final = scipy_bdf_baseline(sd, rd, calc, prof0, pars.tspan, u0,
                                      RTOL, ATOL, best_of=1)
    cpu_s = time.perf_counter() - t0
    method5 = VariableODESolve(pars, conditions[0], calc)
    t0 = time.perf_counter()
    EnsembleProblem(method5, sd, rd, rate_mode="continuous",
                    chunk_mode="async", device=dev).solve(
                        conditions_list=conditions)
    warm_s = time.perf_counter() - t0
    counts.reset()
    problem = EnsembleProblem(method5, sd, rd, rate_mode="continuous",
                              chunk_mode="async", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = problem.solve(conditions_list=conditions)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    if not ens.success:
        fail(f"not every lane DONE: {ens.retcodes}")
    if not np.all(np.isfinite(ens.u)) or ens.u.shape != (BATCH, 1 + int(TF / CHUNK), sd.n):
        fail(f"bad solution array {ens.u.shape}")
    err = final_err(ens.u[0, -1], cpu_final)
    if err > 1e-6:
        fail(f"member 0 differs from scipy-BDF by {err:.3e} (> 1e-6)")
    require_launched(5, launches, ("fused_rhs", "gj_inverse", "grid_probe"))
    steps = np.asarray(ens.stats["n_steps"])
    steps_max, steps_med = int(steps.max()), int(np.median(steps))
    say(f"phase 5 continuous sweep: {rd.nr} rxn / {sd.n} sp, B={BATCH}, "
        f"{problem.n_chunks} async chunks: all DONE; member 0 vs scipy-BDF max "
        f"mole-fraction err {err:.3e}; {sweep_s * 1e3 / BATCH:.2f} ms/profile "
        f"({sweep_s:.3f} s sweep, warm-up {warm_s:.3f} s, scipy-BDF one "
        f"profile {cpu_s:.3f} s on this host); steps max/median "
        f"{steps_max}/{steps_med}; {sweep_s * 1e3 / steps_max:.3f} ms/step; "
        f"host syncs {syncs} ({syncs / steps_max:.2f}/step); rejected "
        f"{int(ens.stats['n_rejected'].sum())}, factors "
        f"{int(ens.stats['n_lu'].sum())} (all lanes); attempts "
        f"{ens.stats['attempts']} retry batch {ens.stats['retry_batch']}; "
        f"launches {launches} ({sum(launches.values()) / steps_max:.2f} of "
        f"these kernels/step)")
    record("5", launches, steps_max)

    # ---- phase 6: solve_network, member 0's ramp, inv_fused + dd ----
    sd6, rd6, calc6, conds6, pars6 = build_problem(
        dev, linsolve="inv_fused", rhs_contraction="dd")
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve_network(VariableODESolve(pars6, conds6[0], calc6), sd6, rd6,
                        device=dev)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    sol = out.sol
    if not sol.success:
        fail(f"solve_network: {sol.retcode}")
    if sol.u.shape != (1 + int(TF / CHUNK), sd.n) or not np.all(np.isfinite(sol.u)):
        fail(f"solve_network: bad solution array {sol.u.shape}")
    err6 = final_err(sol.u[-1], cpu_final)
    if err6 > 1e-6:
        fail(f"solve_network differs from scipy-BDF by {err6:.3e} (> 1e-6)")
    require_launched(6, launches, ("dd_contract", "newton_solve", "gj_inverse",
                                   "grid_probe"))
    if launches["fused_rhs"]:
        fail(f"phase 6 ran the fused RHS with rhs_contraction='dd': {launches}")
    st = sol.stats
    say(f"phase 6 solve_network: chunkwise {st['n_chunks']} x {CHUNK} s, "
        f"continuous, inv_fused + dd: DONE; vs scipy-BDF max mole-fraction err "
        f"{err6:.3e}; {single_s * 1e3:.2f} ms/profile; steps {st['n_steps']} "
        f"(accepted {st['n_accepted']}, rejected {st['n_rejected']}, factors "
        f"{st['n_lu']}); {single_s * 1e3 / st['n_steps']:.3f} ms/step; host "
        f"syncs {syncs} ({syncs / st['n_steps']:.2f}/step); launches {launches} "
        f"({sum(launches.values()) / st['n_steps']:.2f} of these kernels/step)"
        + newton_device("6", launches, st['n_steps'], "graph_ms_b1"))
    record("6", launches, st['n_steps'])

    # ---- phase 7: the discrete ensemble, inv_fused + dd ----
    sd7, rd7, calc7, conds7, pars7 = build_problem(
        dev, ts_update=TS_UPDATE, linsolve="inv_fused", rhs_contraction="dd")
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem7 = EnsembleProblem(VariableODESolve(pars7, conds7[0], calc7), sd7,
                               rd7, device=dev)
    ens7 = problem7.solve(conditions_list=conds7)
    torch.cuda.synchronize()
    disc_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    if problem7.rate_mode != "discrete" or problem7.chunk_mode != "async":
        fail(f"ensemble defaults: {problem7.rate_mode}/{problem7.chunk_mode}")
    if not ens7.success:
        fail(f"discrete ensemble: not every lane DONE: {ens7.retcodes}")
    if ens7.u.shape != (BATCH, 1 + int(TF / CHUNK), sd.n) or not np.all(
            np.isfinite(ens7.u)):
        fail(f"discrete ensemble: bad solution array {ens7.u.shape}")
    tstops7 = conds7[0].get_tstops()
    t0 = time.perf_counter()
    disc_final = scipy_bdf_discrete_baseline(
        sd7, rd7, calc7, conds7[0].get_profile("T"), pars7.tspan, u0, RTOL,
        ATOL, tstops7)
    cpu7_s = time.perf_counter() - t0
    err7 = final_err(ens7.u[0, -1], disc_final)
    if err7 > 1e-6:
        fail(f"discrete member 0 differs from the segment-wise scipy-BDF "
             f"reference by {err7:.3e} (> 1e-6)")
    require_launched(7, launches, ("dd_contract", "newton_solve", "gj_inverse",
                                   "grid_probe"))
    steps7 = np.asarray(ens7.stats["n_steps"])
    s7_max, s7_med = int(steps7.max()), int(np.median(steps7))
    say(f"phase 7 discrete ensemble: B={BATCH}, {tstops7.size} rate stops "
        f"({TS_UPDATE} s), {problem7.n_chunks} async chunks, inv_fused + dd: "
        f"all DONE; member 0 vs segment-wise scipy-BDF max mole-fraction err "
        f"{err7:.3e} (continuous-k gap {final_err(ens7.u[0, -1], cpu_final):.3e}"
        f"); {disc_s * 1e3 / BATCH:.2f} ms/profile ({disc_s:.3f} s, set-up "
        f"included; scipy reference {cpu7_s:.3f} s on this host); steps "
        f"max/median {s7_max}/{s7_med}; {disc_s * 1e3 / s7_max:.3f} ms/step; "
        f"host syncs {syncs} ({syncs / s7_max:.2f}/step); attempts "
        f"{ens7.stats['attempts']}; launches {launches} "
        f"({sum(launches.values()) / s7_max:.2f} of these kernels/step)"
        + newton_device("7", launches, s7_max, "graph_ms"))
    record("7", launches, s7_max)

    # ---- phase 8: the nc=60 continuous sweep (multi-tile), B=64 ----
    # warm-up: B=8 over the first two chunks (new widths for cuBLAS and the
    # Schur blocks); then the counted sweep at full width and depth
    t0 = time.perf_counter()
    _, cpu60_final = scipy_bdf_baseline(sd60, rd60, calc60, prof60, pars60.tspan,
                                        u0_60, RTOL, ATOL, best_of=1)
    cpu60_s = time.perf_counter() - t0
    sdw, rdw, calcw, condsw, parsw = build_problem(
        dev, n_carbons=WIDE_CARBONS, batch=8, tf=2 * CHUNK)
    t0 = time.perf_counter()
    EnsembleProblem(VariableODESolve(parsw, condsw[0], calcw), sdw, rdw,
                    rate_mode="continuous", device=dev).solve(
                        conditions_list=condsw)
    warm8_s = time.perf_counter() - t0
    counts.reset()
    problem8 = EnsembleProblem(VariableODESolve(pars60, conds60[0], calc60),
                               sd60, rd60, rate_mode="continuous", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens8 = problem8.solve(conditions_list=conds60)
    torch.cuda.synchronize()
    sweep8_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    refreshes = counts.bdf.jac_refreshes
    # each lane evaluates J once at its start; the other evaluations are
    # the lanes the refreshes served
    refresh_lanes = int(ens8.stats["n_jev"].sum()) - BATCH
    if not ens8.success:
        fail(f"phase 8: not every lane DONE: {ens8.retcodes}")
    if ens8.u.shape != (BATCH, 1 + int(TF / CHUNK), sd60.n) or not np.all(
            np.isfinite(ens8.u)):
        fail(f"phase 8: bad solution array {ens8.u.shape}")
    err8 = final_err(ens8.u[0, -1], cpu60_final)
    if err8 > 1e-6:
        fail(f"phase 8: member 0 differs from scipy-BDF by {err8:.3e} (> 1e-6)")
    require_launched(8, launches, ("fused_rhs", "gj_inverse", "grid_probe"))
    st8 = ens8.stats
    s8 = np.asarray(st8["n_steps"])
    s8_max, s8_med = int(s8.max()), int(np.median(s8))
    say(f"phase 8 nc={WIDE_CARBONS} continuous sweep: {rd60.nr} rxn / "
        f"{sd60.n} sp, B={BATCH}, {problem8.n_chunks} async chunks, inv_gated "
        f"+ fused RHS: all DONE; member 0 vs scipy-BDF max mole-fraction err "
        f"{err8:.3e}; {sweep8_s * 1e3 / BATCH:.2f} ms/profile ({sweep8_s:.3f} "
        f"s sweep, B=8 two-chunk warm-up {warm8_s:.3f} s, scipy-BDF one "
        f"profile {cpu60_s:.3f} s and to mid-ramp {mid60_s:.3f} s on this "
        f"host); steps max/median {s8_max}/{s8_med}; "
        f"{sweep8_s * 1e3 / s8_max:.3f} ms/step; host syncs {syncs} "
        f"({syncs / s8_max:.2f}/step); rejected {int(st8['n_rejected'].sum())}"
        f", factors {int(st8['n_lu'].sum())}, J evaluations "
        f"{int(st8['n_jev'].sum())} (all lanes); J refreshes {refreshes}, "
        f"{refresh_lanes / max(refreshes, 1):.2f} lanes per refresh; attempts "
        f"{st8['attempts']}; launches {launches} "
        f"({sum(launches.values()) / s8_max:.2f} of these kernels/step)")
    record("8", launches, s8_max)

    # ---- phase 9: solve_network at nc=60, member 0, inv_fused + dd ----
    sd9, rd9, calc9, conds9, pars9 = build_problem(
        dev, n_carbons=WIDE_CARBONS, linsolve="inv_fused",
        rhs_contraction="dd")
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out9 = solve_network(VariableODESolve(pars9, conds9[0], calc9), sd9, rd9,
                         device=dev)
    torch.cuda.synchronize()
    single9_s = time.perf_counter() - t0
    launches, syncs = counts.read()
    sol9 = out9.sol
    if not sol9.success:
        fail(f"phase 9 solve_network: {sol9.retcode}")
    if sol9.u.shape != (1 + int(TF / CHUNK), sd9.n) or not np.all(
            np.isfinite(sol9.u)):
        fail(f"phase 9 solve_network: bad solution array {sol9.u.shape}")
    err9 = final_err(sol9.u[-1], cpu60_final)
    if err9 > 1e-6:
        fail(f"phase 9: solve_network differs from scipy-BDF by {err9:.3e} "
             "(> 1e-6)")
    require_launched(9, launches, ("dd_contract", "newton_solve", "gj_inverse",
                                   "grid_probe"))
    if launches["fused_rhs"]:
        fail(f"phase 9 ran the fused RHS with rhs_contraction='dd': {launches}")
    st9 = sol9.stats
    say(f"phase 9 solve_network nc={WIDE_CARBONS}: {rd9.nr} rxn / {sd9.n} sp, "
        f"chunkwise {st9['n_chunks']} x {CHUNK} s, continuous, inv_fused + dd:"
        f" DONE; vs scipy-BDF max mole-fraction err {err9:.3e}; "
        f"{single9_s * 1e3:.2f} ms/profile; steps {st9['n_steps']} (accepted "
        f"{st9['n_accepted']}, rejected {st9['n_rejected']}, factors "
        f"{st9['n_lu']}); {single9_s * 1e3 / st9['n_steps']:.3f} ms/step; "
        f"host syncs {syncs} ({syncs / st9['n_steps']:.2f}/step); launches "
        f"{launches} ({sum(launches.values()) / st9['n_steps']:.2f} of these "
        f"kernels/step)"
        + newton_device("9", launches, st9['n_steps'],
                        f"graph_ms_n{sd9.n}_b1"))
    record("9", launches, st9['n_steps'])

    phase_steady_state(dev, counts, record)
    phase_rk45(dev, counts, record)
    phase_float32(dev, counts, record, ens7, pars7, conds7, calc7, sd7, rd7)

    # ---- phases 17-20: exploration, calculators, sharding, profiling ----
    def record_ranks(phase, launches_by_rank, steps):
        """A sharded path's launches, and each rank's launches per step."""
        for kname in KERNELS:
            total[kname] += sum(la[kname] for la in launches_by_rank)
            per_step[kname][phase] = [la[kname] / steps
                                      for la in launches_by_rank]

    def collect(name):
        """A side process's phases: their lines printed, their launches
        recorded."""
        try:
            res = side[name].result()
        except Exception as exc:
            fail(f"phases {name} (in a process of their own): "
                 f"{type(exc).__name__}: {exc}")
        for line in res["lines"]:
            say(line)
        for rec in res["recorded"]:
            record(*rec)

    # phase 17's scipy references (member 63's stalls) run in a pool beside
    # phases 18-20, checked at the end; phase 20 comes last (launches cost
    # more in a process after a torch.profiler session: PERF.md)
    with spawn_pool(4) as pool:
        for sub in ("17", "20"):
            os.makedirs(os.path.join(work, sub))
        t0 = time.perf_counter()
        res17, check17 = phase_explore(dev, counts, record,
                                       os.path.join(work, "17"), pool)
        phase_calculators(dev, counts, record, os.path.join(work, "17"),
                          res17.sd, res17.rd)
        say(f"phases 17-18: {time.perf_counter() - t0:.1f} s on this card "
            "(phase 17's references checked after phase 20)")

        t0 = time.perf_counter()
        phase_sharded(dev, record_ranks, ens, ens7)
        t19 = time.perf_counter() - t0
        phase_profiling(dev, counts, record, os.path.join(work, "20"))
        say(f"phases 19-20: {t19:.1f} + {time.perf_counter() - t0 - t19:.1f} "
            "s on this card")
        check17()

    for name in side:
        if name != "22":
            collect(name)
    phase_tutorials(side["22"], record, card)
    say(f"phases 11, 14-16, 21 and 22 in their processes: "
        f"{time.perf_counter() - side_t0:.1f} s from their start to the last "
        f"result [{card}]")
    children.shutdown()
    shutil.rmtree(work, ignore_errors=True)

    # ---- phase 23: the measurement programs, alone on the card ----
    t0 = time.perf_counter()
    phase_programs(record, card, f"{rd.nr}rxn/{sd.n}sp")
    say(f"phase 23: {time.perf_counter() - t0:.1f} s on this card")

    for kname in KERNELS:
        kernels[kname]["launches"] = total[kname]
        kernels[kname]["launches_per_step"] = per_step[kname]
    kernels["newton_solve"]["device_ms_per_step"] = newton_step_ms
    # the f32 Gauss-Jordan kernel is off the main path: it has no launches
    say(json.dumps({"kernels": [kernels[k] for k in KERNELS]
                    + [kernels["gj_inverse_f32"]]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # a run stopped from outside stops every process it started
    signal.signal(signal.SIGTERM, lambda *_: fail("stopped by SIGTERM"))
    try:
        main()
    finally:
        kill_children()
    gc.collect()        # the pools' semaphores unregistered while it runs
    stop_resource_tracker()
