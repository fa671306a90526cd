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

Each path is held against a pure-numpy scipy-BDF reference, and every
kernel of a path must have launched during that path's run (the counts
are set to 0, and the once-per-process grid probe re-armed, just before
it).

Phases 3-4 also hold the kernels on their edge cases
(``kinetica_tpu_torch.testing.kernel_cases``: Gauss-Jordan at n = 1, 33,
53, 73, 127, 128 with a pivot tie, a NaN column and a singular member;
the fused RHS at B = 1 and 64 on a network with an empty and a 700-entry
species row), and time every kernel three ways
(``kinetica_tpu_torch.testing.device_timing``): ``ms`` (one call between
CUDA events, host work included), ``graph_ms`` (device only: 20 calls in
one CUDA graph, replayed) and ``library_ms`` (the one PyTorch call that
computes the same function, where there is one: timed as ``graph_ms``,
or over 20 calls back to back where a graph cannot capture it), beside
``bound_ms`` (the bytes or the operations of the work at the H100's
peak rates). The ``kernels`` line also gives each kernel's launches per
step on each path.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA GPU. Exits non-zero, printing no result line, when there is
no GPU, when the package is not next to this script, or when any phase
fails. The last line of standard output is the JSON result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_CARBONS, BATCH, TF, CHUNK, TS_UPDATE = 24, 64, 14.0, 0.5, 0.1
WIDE_CARBONS, WIDE_N = 60, 512      # the multi-tile network; the widest inverse
RTOL, ATOL, K_MAX = 1e-8, 1e-10, 1e12
KERNELS = ("fused_rhs", "gj_inverse", "dd_contract", "newton_solve",
           "grid_probe")
# the yardstick of the inverses: a CUDA graph cannot capture it (it
# synchronises inside), so it is timed over 20 calls back to back
LIBRARY_INV = "torch.linalg.inv_ex, loop_ms"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
    from kinetica_tpu_torch.ops.newton_solve import (fused_newton_solve,
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
        GJ_EDGE_WIDTHS, gj_edge_cases, rhs_edge_network, rhs_rel_err)

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
    # one exactly singular member
    u0 = make_u0(sd, pars)
    prof0 = conditions[0].get_profile("T")
    _, u_mid = scipy_bdf_baseline(sd, rd, calc, prof0, (0.0, TF / 2), u0,
                                  RTOL, ATOL, best_of=1)
    jnet = net.to_dtype(torch.float32)
    T_mid = prof0.X_start + prof0.rate * TF / 2
    J = jnet.jac_matmul(torch.as_tensor(u_mid, device=dev).float(),
                        calc(T_mid).float())
    c = torch.as_tensor(np.logspace(-11, -5.5, BATCH), device=dev)
    JB = J.expand(BATCH, -1, -1).contiguous()
    As, _, _ = _equilibrate(_newton_matrix(JB, c))
    As = As.contiguous()
    As[BATCH - 1, :, 5] = 0.0                                  # singular
    M_k = gj_inverse.gj_inverse(As)
    torch.cuda.synchronize()
    M_p = gj_inverse.gj_inverse_plain(As)
    d = (M_k.double() - M_p.double())
    rel = d.norm(dim=(1, 2)) / M_p.double().norm(dim=(1, 2))
    resid = (torch.eye(sd.n, dtype=torch.float64, device=dev)
             - As.double() @ M_k.double()).abs().amax(dim=(1, 2))[:-1]
    max_err2 = float(d[:-1].abs().max())                     # non-singular
    # the kernel rounds as the plain version does: count what differs
    n_diff2 = int((M_k != M_p).sum())
    if not bool(torch.isfinite(M_k).all()):
        fail("gj_inverse gave non-finite values")
    if float(rel.max()) > 1e-5 or float(resid.max()) > 1e-3:
        fail(f"gj_inverse: max relative Frobenius {float(rel.max()):.3e}, "
             f"max |I - A M| {float(resid.max()):.3e}")
    # edge cases at every tile edge: a pivot tie, a NaN column (the member
    # all NaN, no other touched), a singular member (finite)
    edge2 = {}
    for n in GJ_EDGE_WIDTHS:
        A_np, names = gj_edge_cases(n, seed=n)
        A_e = torch.as_tensor(A_np, device=dev)
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
        res_e = max(float((eye_e - A_e[i].double() @ M_e[i].double()).abs().max())
                    for i in range(len(names)) if names[i] in ("random", "tie"))
        if not (edge2[n] <= 1e-5 and res_e <= 1e-3
                and bool(torch.isfinite(M_e[keep]).all())
                and bool(torch.isnan(M_e[nan]).all())):
            fail(f"gj_inverse edge cases n={n} ({names}): max rel Frobenius "
                 f"{edge2[n]:.3e}, max |I - A M| {res_e:.3e}, finite "
                 f"{bool(torch.isfinite(M_e[keep]).all())}, NaN member all "
                 f"NaN {bool(torch.isnan(M_e[nan]).all())}")
    ms2 = cuda_ms(lambda: gj_inverse.gj_inverse(As))
    g2 = graph_ms(lambda: gj_inverse.gj_inverse(As))
    ms2p = cuda_ms(lambda: gj_inverse.gj_inverse_plain(As), n=5, warm=1)
    lib2 = loop_ms(lambda: torch.linalg.inv_ex(As)[0])
    b2, by2 = bound(*inverse_work(BATCH, sd.n), "f32")
    A128 = (torch.eye(128, device=dev) + torch.as_tensor(
        rng.standard_normal((BATCH, 128, 128)) / (2 * 128 ** 0.5),
        device=dev).float()).contiguous()
    g2_128 = graph_ms(lambda: gj_inverse.gj_inverse(A128))
    lib2_128 = loop_ms(lambda: torch.linalg.inv_ex(A128)[0])
    b2_128, by2_128 = bound(*inverse_work(BATCH, 128), "f32")
    say(f"phase 4 gj_inverse: B={BATCH} n={sd.n}: max rel Frobenius "
        f"{float(rel.max()):.3e} (<= 1e-5), max |d| {max_err2:.3e} (max |M| "
        f"{float(M_p[:-1].abs().max()):.3e}, non-singular), max |I - A M| "
        f"{float(resid.max()):.3e} (<= 1e-3, non-singular), singular member "
        f"finite; edge cases (tie, NaN column, singular) max rel Frobenius "
        + ", ".join(f"n={n} {e:.2e}" for n, e in edge2.items())
        + f" (<= 1e-5); {n_diff2} entries differ from the plain version in "
        f"all; kernel {ms2:.4f} ms, graph {g2:.5f} ms, plain "
        f"{ms2p:.4f} ms, torch.linalg.inv_ex {lib2:.5f} ms, bound {b2:.5f} ms "
        f"({by2}) | n=128: graph {g2_128:.5f} ms, torch.linalg.inv_ex "
        f"{lib2_128:.5f} ms, bound {b2_128:.5f} ms ({by2_128})")
    kernels["gj_inverse"] = {
        "name": "gj_inverse", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/gj_inverse.cu",
        "replaces": "kinetica_tpu/ops/pallas_linalg.py:71",
        "max_abs_err": max_err2, "max_rel_err": float(rel.max()),
        "entries_differing_from_plain": n_diff2, "ms": ms2, "graph_ms": g2,
        "plain_ms": ms2p, "bound_ms": b2, "bound_by": by2,
        "library_ms": lib2, "library_call": LIBRARY_INV,
        "graph_ms_n128": g2_128, "library_ms_n128": lib2_128,
        "bound_ms_n128": b2_128, "bound_by_n128": by2_128}

    # ---- phase 4b: the widest shapes of the RHS and Gauss-Jordan kernels ----
    # off the main path: the fused RHS launch that raises the dynamic
    # shared-memory limit (nr = 8000 reactions, 64.6 KB of rates), and the
    # Gauss-Jordan kernel at its full 128-wide tile
    nr_w = 8000
    N_w = rng.integers(-2, 3, (nr_w, sd.n)).astype(np.float64)
    slots_w = rng.integers(0, sd.n + 1, (nr_w, 2))
    wide = FusedMassActionRHS(N_w, slots_w, dev)
    k_w = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (BATCH, nr_w)), device=dev)
    r_w = k_w * u_aug[:, torch.as_tensor(slots_w, device=dev)].prod(dim=-1)
    bound_w = r_w.abs() @ torch.as_tensor(np.abs(N_w), device=dev)
    rel_w1 = float(((wide(u_aug, k_w) - wide.plain(u_aug, k_w)).abs()
                    / bound_w.clamp_min(1e-300)).max())
    A_w = (torch.eye(128, device=dev) + torch.as_tensor(
        rng.standard_normal((8, 128, 128)) / 128 ** 0.5, device=dev).float())
    M_w, M_wp = gj_inverse.gj_inverse(A_w), gj_inverse.gj_inverse_plain(A_w)
    rel_w2 = float(((M_w - M_wp).double().norm(dim=(1, 2))
                    / M_wp.double().norm(dim=(1, 2))).max())
    if not (rel_w1 <= 1e-12 and rel_w2 <= 1e-5):
        fail(f"wide shapes: fused_rhs max |d| / sum|N r| {rel_w1:.3e}, "
             f"gj_inverse max rel Frobenius {rel_w2:.3e}")
    say(f"phase 4b wide shapes: fused_rhs nr={nr_w} max |d| / sum|N r| "
        f"{rel_w1:.3e} (<= 1e-12); gj_inverse n=128 max rel Frobenius "
        f"{rel_w2:.3e} (<= 1e-5)")

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
    ms4 = cuda_ms(lambda: fused_newton_solve(M4, JB, b4, c))
    g4 = graph_ms(lambda: fused_newton_solve(M4, JB, b4, c))
    ms4p = cuda_ms(lambda: fused_newton_solve_plain(M4, JB, b4, c))
    b4_ms, by4 = bound(*solve_work(BATCH, sd.n), "f32")
    say(f"phase 4d newton_solve: B={BATCH} n={sd.n}: per-lane max |d| / "
        f"max|dy| {lane4:.3e} (<= 1e-5), max |b - A dy| / |b| {res4_f:.3e} "
        f"(<= 1e-4; lane {STALE}, M at 1.2 c = {float(c[STALE]):.2e}, "
        f"not bounded: {res4_s:.3e}); n=128: {lane4_w:.3e}, residual "
        f"{float(res4_w.max()):.3e}; kernel {ms4:.4f} ms, graph {g4:.5f} ms, "
        f"plain {ms4p:.4f} ms, bound {b4_ms:.5f} ms ({by4}), no single "
        f"library call")
    kernels["newton_solve"] = {
        "name": "newton_solve", "route": "cuda",
        "source": "kinetica_tpu_torch/csrc/newton_solve.cu",
        "replaces": "kinetica_tpu/ops/pallas_linalg.py:283",
        "max_abs_err": max_err4, "max_rel_err": lane4, "ms": ms4,
        "graph_ms": g4, "plain_ms": ms4p, "bound_ms": b4_ms, "bound_by": by4,
        "library_ms": None, "library_call": "no single call (inverse "
        "application, f64-residual refinement, per-lane stop)"}

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
    _, u_mid60 = scipy_bdf_baseline(sd60, rd60, calc60, prof60, (0.0, TF / 2),
                                    u0_60, RTOL, ATOL, best_of=1)
    mid60_s = time.perf_counter() - t0
    J60 = net60.to_dtype(torch.float32).jac_matmul(
        torch.as_tensor(u_mid60, device=dev).float(),
        calc60(prof60.X_start + prof60.rate * TF / 2).float())
    J60B = J60.expand(BATCH, -1, -1).contiguous()
    A181 = _newton_matrix(J60B, c)
    n_w = WIDE_N
    J512 = torch.as_tensor(rng.standard_normal((8, n_w, n_w)),
                           device=dev).float().contiguous()
    c512 = torch.full((8,), 0.025, dtype=torch.float64, device=dev)
    A512 = _newton_matrix(J512, c512)
    wide = {}
    for n, A_n in ((sd60.n, A181), (n_w, A512)):
        As_n = _equilibrate(A_n)[0].contiguous()
        M_k = gj_inverse.schur_inverse(As_n)
        torch.cuda.synchronize()
        M_p = gj_inverse.schur_inverse_plain(As_n)
        rel_s = float(((M_k - M_p).double().norm(dim=(1, 2))
                       / M_p.double().norm(dim=(1, 2))).max())
        M_r, _ = newton_schulz_refine(M_k, As_n)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        res_s = float((eye - As_n.double() @ M_r.double()).abs().max())
        if not (bool(torch.isfinite(M_k).all()) and rel_s <= 1e-5
                and res_s <= 1e-3):
            fail(f"schur_inverse n={n}: max rel Frobenius {rel_s:.3e}, max "
                 f"|I - A M| after Newton-Schulz {res_s:.3e}")
        ms_s = cuda_ms(lambda: gj_inverse.schur_inverse(As_n))
        g_s = graph_ms(lambda: gj_inverse.schur_inverse(As_n))
        ms_sp = cuda_ms(lambda: gj_inverse.schur_inverse_plain(As_n), n=5,
                        warm=1)
        lib_s = loop_ms(lambda: torch.linalg.inv_ex(As_n)[0])
        b_s, by_s = bound(*inverse_work(A_n.shape[0], n), "f32")
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
        if not (lane_n <= 1e-5 and float(res_n.max()) <= 1e-4):
            fail(f"newton_solve n={n}: per-lane max |d| / max|dy| "
                 f"{lane_n:.3e}, max residual {float(res_n.max()):.3e}")
        ms_n = cuda_ms(lambda: fused_newton_solve(M_f, J_n, b_n, c_n))
        g_n = graph_ms(lambda: fused_newton_solve(M_f, J_n, b_n, c_n))
        ms_np = cuda_ms(lambda: fused_newton_solve_plain(M_f, J_n, b_n, c_n))
        b_n_ms, by_n = bound(*solve_work(A_n.shape[0], n), "f32")
        kernels["gj_inverse"].update({
            f"ms_n{n}": ms_s, f"graph_ms_n{n}": g_s, f"plain_ms_n{n}": ms_sp,
            f"library_ms_n{n}": lib_s, f"bound_ms_n{n}": b_s,
            f"bound_by_n{n}": by_s})
        kernels["newton_solve"].update({
            f"ms_n{n}": ms_n, f"graph_ms_n{n}": g_n, f"plain_ms_n{n}": ms_np,
            f"bound_ms_n{n}": b_n_ms, f"bound_by_n{n}": by_n})
        say(f"phase 4f n={n} B={A_n.shape[0]}: schur_inverse max rel "
            f"Frobenius {rel_s:.3e} (<= 1e-5), max |I - A M| after "
            f"Newton-Schulz {res_s:.3e} (<= 1e-3); kernel {ms_s:.4f} ms, graph "
            f"{g_s:.5f} ms, plain {ms_sp:.4f} ms, torch.linalg.inv_ex "
            f"{lib_s:.5f} ms, bound {b_s:.5f} ms ({by_s}) | newton_solve "
            f"per-lane max |d| / max|dy| {lane_n:.3e} (<= 1e-5), max |b - A dy|"
            f" / |b| {float(res_n.max()):.3e} (<= 1e-4); kernel {ms_n:.4f} ms, "
            f"graph {g_n:.5f} ms, plain {ms_np:.4f} ms, bound {b_n_ms:.5f} ms "
            f"({by_n})")
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
    total = dict.fromkeys(KERNELS, 0)
    per_step = {kname: {} for kname in KERNELS}

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
        f"({sum(launches.values()) / st['n_steps']:.2f} of these kernels/step)")
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
        f"({sum(launches.values()) / s7_max:.2f} of these kernels/step)")
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
        f"kernels/step)")
    record("9", launches, st9['n_steps'])

    for kname in KERNELS:
        kernels[kname]["launches"] = total[kname]
        kernels[kname]["launches_per_step"] = per_step[kname]
    say(json.dumps({"kernels": [kernels[k] for k in KERNELS]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
