"""Smoke run of kinetica_tpu_torch on one NVIDIA GPU.

Builds the port's two CUDA kernels from ``kinetica_tpu_torch/csrc``,
checks each against its plain PyTorch version at the shapes of the main
path, then drives the main path once through its public entry point: the
64-profile variable-temperature sweep of ``bench.py`` (1095 reactions,
73 species, 28 async chunks of 0.5 s, continuous rates) through
``kinetica_tpu_torch.parallel.batching.EnsembleProblem``. Member 0 is held
against the pure-numpy scipy-BDF baseline, and the kernels' launch counts
during the timed solve must be positive.

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
N_CARBONS, BATCH, TF, CHUNK = 24, 64, 14.0, 0.5
RTOL, ATOL, K_MAX = 1e-8, 1e-10, 1e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int = 25, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def build_problem(device):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network

    sd, rd, Ea, A = synthetic_pyrolysis_network(N_CARBONS)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=K_MAX, device=device)
    conditions = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=500.0, X_end=500.0 + float(r) * TF)})
        for r in np.linspace(40.0, 60.0, BATCH)]
    pars = ODESimulationParams(
        tspan=(0.0, TF), u0={f"C{N_CARBONS}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=ATOL, reltol=RTOL,
        linsolve="auto", jac_policy="lazy", lu_drift_tol=0.3)
    return sd, rd, calc, conditions, pars


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    import_port()
    import kinetica_tpu_torch.precision as precision
    from kinetica_tpu_torch.models.mass_action import augment, build_mass_action
    from kinetica_tpu_torch.ops import cuda_build, fused_rhs, gj_inverse, host_sync
    from kinetica_tpu_torch.ops.linalg import _equilibrate, _newton_matrix
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import scipy_bdf_baseline

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

    # ---- phase 2: build both kernels from the checkout's sources ----
    for name in ("fused_rhs", "gj_inverse"):
        cuda_build.load_library(name)
        info = cuda_build.build_info[name]
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        say(f"phase 2 build {name}: {info['seconds']:.2f} s; "
            f"{' | '.join(regs) or 'cached'}")

    sd, rd, calc, conditions, pars = build_problem(dev)
    net = build_mass_action(rd, sd.n, device=dev)
    rng = np.random.default_rng(2024)
    kernels = []

    # ---- phase 3: fused RHS kernel vs its plain version, B=64 / nc=24 ----
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    fused = FusedMassActionRHS(net.N, net.reac_slots, dev)
    u = 10.0 ** rng.uniform(-14, 0, (BATCH, sd.n))
    u[rng.random((BATCH, sd.n)) < 0.2] = 0.0
    u_aug = augment(torch.as_tensor(u, device=dev), net.delta).contiguous()
    k = calc(torch.as_tensor(rng.uniform(700.0, 1300.0, BATCH),
                             dtype=torch.float64, device=dev)).contiguous()
    du_k = fused(u_aug, k)
    torch.cuda.synchronize()
    du_p = fused.plain(u_aug, k)
    r = k * u_aug[:, net.reac_slots].prod(dim=-1)
    bound = r.abs() @ net.N.abs()
    err1 = (du_k - du_p).abs()
    max_err1 = float(err1.max())
    rel1 = float((err1 / bound.clamp_min(1e-300)).max())
    if not rel1 <= 1e-12:
        fail(f"fused_rhs disagrees with its plain version: max |d| "
             f"{max_err1:.3e}, max |d| / sum|N r| {rel1:.3e}")
    ms1 = cuda_ms(lambda: fused(u_aug, k))
    ms1p = cuda_ms(lambda: fused.plain(u_aug, k))
    say(f"phase 3 fused_rhs: B={BATCH} nr={rd.nr} ns={sd.n}: max |d| "
        f"{max_err1:.3e} (max |du| {float(du_p.abs().max()):.3e}), max |d| / "
        f"sum|N r| {rel1:.3e} (<= 1e-12); kernel {ms1:.4f} ms, plain "
        f"{ms1p:.4f} ms")
    kernels.append({"name": "fused_rhs", "route": "cuda",
                    "source": "kinetica_tpu_torch/csrc/fused_rhs.cu",
                    "replaces": "kinetica_tpu/ops/pallas_matmul.py:384",
                    "max_abs_err": max_err1, "max_rel_err": rel1,
                    "ms": ms1, "plain_ms": ms1p})

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
    As, _, _ = _equilibrate(_newton_matrix(J.expand(BATCH, -1, -1), c))
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
    if not bool(torch.isfinite(M_k).all()):
        fail("gj_inverse gave non-finite values")
    if float(rel.max()) > 1e-5 or float(resid.max()) > 1e-3:
        fail(f"gj_inverse: max relative Frobenius {float(rel.max()):.3e}, "
             f"max |I - A M| {float(resid.max()):.3e}")
    ms2 = cuda_ms(lambda: gj_inverse.gj_inverse(As))
    ms2p = cuda_ms(lambda: gj_inverse.gj_inverse_plain(As), n=5, warm=1)
    say(f"phase 4 gj_inverse: B={BATCH} n={sd.n}: max rel Frobenius "
        f"{float(rel.max()):.3e} (<= 1e-5), max |d| {max_err2:.3e} (max |M| "
        f"{float(M_p[:-1].abs().max()):.3e}, non-singular), max |I - A M| "
        f"{float(resid.max()):.3e} (<= 1e-3, non-singular), singular member "
        f"finite; kernel {ms2:.4f} ms, plain {ms2p:.4f} ms")
    kernels.append({"name": "gj_inverse", "route": "cuda",
                    "source": "kinetica_tpu_torch/csrc/gj_inverse.cu",
                    "replaces": "kinetica_tpu/ops/pallas_linalg.py:71",
                    "max_abs_err": max_err2, "max_rel_err": float(rel.max()),
                    "ms": ms2, "plain_ms": ms2p})

    # ---- phase 4b: each kernel above 48 KB of shared memory ----
    # off the main path: the launch that raises the dynamic shared-memory
    # limit, at nr = 8000 reactions (64.6 KB of rates) and n = 128 (131.6 KB)
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

    # ---- phase 5: the main path, warm-up then timed ----
    t0 = time.perf_counter()
    _, cpu_final = scipy_bdf_baseline(sd, rd, calc, prof0, pars.tspan, u0,
                                      RTOL, ATOL, best_of=1)
    cpu_s = time.perf_counter() - t0
    problem = EnsembleProblem(VariableODESolve(pars, conditions[0], calc),
                              sd, rd, rate_mode="continuous",
                              chunk_mode="async", device=dev)
    t0 = time.perf_counter()
    problem.solve(conditions_list=conditions)
    warm_s = time.perf_counter() - t0
    fused_rhs.launches = gj_inverse.launches = host_sync.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = problem.solve(conditions_list=conditions)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = {"fused_rhs": fused_rhs.launches,
                "gj_inverse": gj_inverse.launches}
    syncs = host_sync.count
    if not ens.success:
        fail(f"not every lane DONE: {ens.retcodes}")
    if not np.all(np.isfinite(ens.u)) or ens.u.shape != (BATCH, 1 + int(TF / CHUNK), sd.n):
        fail(f"bad solution array {ens.u.shape}")
    err = float(np.max(np.abs(ens.u[0, -1] - cpu_final)
                       / max(cpu_final.sum(), 1.0)))
    if err > 1e-6:
        fail(f"member 0 differs from scipy-BDF by {err:.3e} (> 1e-6)")
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched during the timed solve: {launches}")
    steps = np.asarray(ens.stats["n_steps"])
    steps_max, steps_med = int(steps.max()), int(np.median(steps))
    say(f"phase 5 main path: {rd.nr} rxn / {sd.n} sp, B={BATCH}, "
        f"{problem.n_chunks} async chunks: all DONE; member 0 vs scipy-BDF max "
        f"mole-fraction err {err:.3e}; {sweep_s * 1e3 / BATCH:.2f} ms/profile "
        f"({sweep_s:.3f} s sweep, warm-up {warm_s:.3f} s, scipy-BDF one "
        f"profile {cpu_s:.3f} s on this host); steps max/median "
        f"{steps_max}/{steps_med}; {sweep_s * 1e3 / steps_max:.3f} ms/step; "
        f"host syncs {syncs} ({syncs / steps_max:.2f}/step); attempts "
        f"{ens.stats['attempts']} retry batch {ens.stats['retry_batch']}; "
        f"launches {launches}")

    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
