"""Check the Gauss-Jordan, fused-RHS, contraction and Newton-solve kernels
at the main path's shapes, and time them against another version of
their sources.

    python -m kinetica_tpu_torch.scripts.kernel_compare [--old DIR] [--out FILE]

Builds ``gj_inverse``, ``fused_rhs``, ``dd_contract`` and
``newton_solve`` from the checkout (printing ``ptxas`` registers and
spills), holds each against its plain version at the shapes of
``chip_smoke.py`` (GJ at n = 73 and 128, B = 64; the block-Schur inverse
at n = 181, B = 64 and n = 512, B = 8; the RHS and the contraction on
``synthetic_pyrolysis_network(24)`` and ``(60)`` at B = 64; the Newton
solve at n = 73 and 181, B = 64 and 1, and n = 512, B = 8) and on the
edge cases of :mod:`kinetica_tpu_torch.testing.kernel_cases`, then times
each shape by :func:`~kinetica_tpu_torch.testing.device_timing.graph_ms`.

With ``--old DIR`` (a directory holding other versions of the kernels'
sources and the headers they include, e.g. a parent commit's
``kinetica_tpu_torch/csrc`` unpacked by ``git archive``), those are built
too and every shape is timed old, new, new, old in one process. The old
Newton solve has the one-block-per-lane launch function
``newton_solve_launch(M, J, b, c, dy, batch, n, n_sweeps, stream)`` or the
cluster one (``..., n_sweeps, cs, stream)``, launched at the new one's
planned cluster size); the new one must equal it bit for bit on every
case, and equal itself at every cluster size the card takes. The result
is one JSON line on standard output, and in ``--out FILE`` if given.
The matrix kernels' inputs are random, made from a seed: their times do
not depend on the values. The Newton solve's time depends on the sweeps
its lanes take, so its inputs are the Newton systems of ``chip_smoke.py``
phases 4d and 4f (the mid-ramp Jacobians of nc = 24 and 60, the main
path's factor), and the lanes per sweep count are printed, with the
time at every cluster size and the host time of a call.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.mass_action import build_mass_action
from ..ops import cuda_build, gj_inverse, newton_solve
from ..ops.dd_contract import DDContraction
from ..ops.fused_rhs import FusedMassActionRHS
from ..ops.linalg import _inv_factor, _newton_matrix
from ..testing.device_timing import (bound, dd_work, graph_ms, host_us,
                                     inverse_work, rhs_work, solve_work)
from ..testing.kernel_cases import (GJ_EDGE_WIDTHS, NEWTON_EDGE_WIDTHS,
                                    gj_edge_cases, mid_ramp_jacobian,
                                    newton_check, newton_edge_cases,
                                    newton_sweeps, rhs_edge_network,
                                    rhs_rel_err)
from ..testing.synthetic import synthetic_pyrolysis_network

NAMES = ("gj_inverse", "fused_rhs", "dd_contract", "newton_solve")
B = 64


def _build_old(old_dir: Path) -> dict[str, ctypes.CDLL]:
    """nvcc each old source (with the package's flags) and load it."""
    libs = {}
    for name in NAMES:
        src = old_dir / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = cuda_build.BUILD_DIR / f"libold_{name}-{digest}.so"
        if not so.exists():
            cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                                   "-o", str(so), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            print(f"old {name}: " + " | ".join(
                ln.strip() for ln in proc.stderr.splitlines()
                if "registers" in ln or "spill" in ln), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _old_gj(lib):
    fn = lib.gj_inverse_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def call(A):
        out = torch.empty_like(A)
        cuda_build.check_launch(fn(A.data_ptr(), out.data_ptr(), A.shape[0],
                                   A.shape[1], _stream()), "old gj_inverse")
        return out
    return call


def _old_fused(lib, fused: FusedMassActionRHS):
    fn = lib.fused_rhs_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def call(u_aug, k):
        du = torch.empty(u_aug.shape[0], fused.ns, dtype=torch.float64,
                         device=u_aug.device)
        cuda_build.check_launch(fn(
            u_aug.data_ptr(), k.data_ptr(), fused.slots.data_ptr(),
            fused.csr.row_ptr.data_ptr(), fused.csr.rxn.data_ptr(),
            fused.csr.coef.data_ptr(), du.data_ptr(), u_aug.shape[0], fused.ns,
            fused.nr, fused.arity, _stream()), "old fused_rhs")
        return du
    return call


def _old_dd(lib, dd: DDContraction):
    fn = lib.dd_contract_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def call(r):
        du = torch.empty(r.shape[0], dd.ns, dtype=torch.float64, device=r.device)
        cuda_build.check_launch(fn(
            r.data_ptr(), dd.csr.row_ptr.data_ptr(), dd.csr.rxn.data_ptr(),
            dd.csr.coef.data_ptr(), du.data_ptr(), r.shape[0], dd.ns, dd.nr,
            _stream()), "old dd_contract")
        return du
    return call


def _old_newton(lib, dev):
    """The old Newton solve: the one-block-per-lane launch function, or the
    cluster one (a library that exports ``newton_solve_max_clusters``)
    at the cluster size the new one plans."""
    fn = lib.newton_solve_launch
    cluster = hasattr(lib, "newton_solve_max_clusters")
    ints = [ctypes.c_int] * (4 if cluster else 3)
    fn.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]

    def call(M, J, b, c, n_sweeps=4):
        dy = torch.empty_like(b)
        size = ((newton_solve._device_plan(b.shape[1], b.shape[0], dev),)
                if cluster else ())
        cuda_build.check_launch(fn(
            M.data_ptr(), J.data_ptr(), b.data_ptr(), c.data_ptr(),
            dy.data_ptr(), b.shape[0], b.shape[1], n_sweeps, *size,
            _stream()), "old newton_solve")
        return dy
    return call


def _newton_cases(dev, rng) -> dict:
    """name -> (M, J, b, c): the Newton systems the comparison times."""
    cases = {}
    c = torch.as_tensor(np.logspace(-11, -5.5, B), device=dev)
    stale = B // 2                      # M built at 1.2 c, as phase 4d
    for nc in (24, 60):
        J = mid_ramp_jacobian(nc, dev).expand(B, -1, -1).contiguous()
        M = _inv_factor(_newton_matrix(J, c)).contiguous()
        M[stale] = _inv_factor(_newton_matrix(J[stale:stale + 1],
                                              1.2 * c[stale:stale + 1]))[0]
        n = J.shape[1]
        b = torch.as_tensor(rng.standard_normal((B, n)), device=dev)
        cases[f"newton_n{n}_b{B}"] = (M, J, b, c)
        # one fresh lane alone: the single solve's shape (phases 6, 9)
        cases[f"newton_n{n}_b1"] = tuple(x[B - 1:B].contiguous()
                                         for x in (M, J, b, c))
    # n = 512, B = 8: random J at c = 0.025, as chip_smoke.py phase 4f
    J512 = torch.as_tensor(rng.standard_normal((8, 512, 512)),
                           device=dev).float().contiguous()
    c512 = torch.full((8,), 0.025, dtype=torch.float64, device=dev)
    M512 = _inv_factor(_newton_matrix(J512, c512)).contiguous()
    b512 = torch.as_tensor(rng.standard_normal((8, 512)), device=dev)
    cases["newton_n512_b8"] = (M512, J512, b512, c512)
    return cases


def check_newton(dev, cases, old=None) -> dict:
    """The new Newton-solve kernel against its plain version, and at every
    cluster size the card takes against the planned one (and the old
    kernel, if given) bit for bit, on the edge cases and ``cases``;
    raises on a miss."""
    every = {}
    for n in NEWTON_EDGE_WIDTHS:
        *arrays, names = newton_edge_cases(n, seed=n)
        M, J, b, c = (torch.as_tensor(x, device=dev) for x in arrays)
        for B_e in (len(names), 1, 0):
            every[f"newton_edge_n{n}_b{B_e}"] = (M[:B_e], J[:B_e], b[:B_e],
                                                 c[:B_e], names[:B_e])
    every.update({k: (*v, None) for k, v in cases.items()})
    out = {}
    for key, (M, J, b, c, names) in every.items():
        res = newton_check(M, J, b, c, names, old)
        if b.shape[0] == 0:
            if not res["shape_ok"]:
                raise RuntimeError(f"{key}: wrong shape")
            continue
        if not (res["lane_rel"] <= 1e-5 and res["finite"]
                and res["nan_lanes_nan"]) or any(res["differing"].values()):
            raise RuntimeError(f"{key}: {res}")
        out[key] = dict(lane_rel=res["lane_rel"],
                        equal_at=list(res["differing"]))
    return out


def _rel_fro(M, ref):
    M, ref = M.double(), ref.double()
    return float(((M - ref).norm(dim=(1, 2)) / ref.norm(dim=(1, 2))).max())


def _random_inverse_input(b, n, rng, dev):
    return torch.as_tensor(np.eye(n) + rng.standard_normal((b, n, n))
                           / (2.0 * np.sqrt(n)),
                           dtype=torch.float32, device=dev).contiguous()


def _rhs_inputs(net, rng, dev, b=B):
    ns, nr = net.ns, net.nr
    u = 10.0 ** rng.uniform(-14, 0, (b, ns))
    u[rng.random((b, ns)) < 0.2] = 0.0
    u_aug = torch.as_tensor(np.concatenate([u, np.ones((b, 1))], axis=1),
                            device=dev)
    k = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (b, nr)), device=dev)
    return u_aug.contiguous(), k.contiguous()


def check(dev, rng) -> dict:
    """Every new kernel against its plain version; raises on a miss."""
    out = {}
    for n in GJ_EDGE_WIDTHS:
        A_np, names = gj_edge_cases(n, seed=n)
        A = torch.as_tensor(A_np, device=dev)
        M, M_p = gj_inverse.gj_inverse(A), gj_inverse.gj_inverse_plain(A)
        torch.cuda.synchronize()
        nan = names.index("nan_column")
        keep = [i for i in range(len(names)) if i != nan]
        rel = _rel_fro(M[keep], M_p[keep])
        fin = bool(torch.isfinite(M[keep]).all())
        all_nan = bool(torch.isnan(M[nan]).all())
        if not (rel <= 1e-5 and fin and all_nan):
            raise RuntimeError(f"gj edge n={n}: rel {rel:.3e}, finite {fin}, "
                               f"NaN member all NaN {all_nan}")
        out[f"gj_edge_n{n}"] = rel
    for n, b in ((73, B), (128, B), (53, B)):
        A = _random_inverse_input(b, n, rng, dev)
        rel = _rel_fro(gj_inverse.gj_inverse(A), gj_inverse.gj_inverse_plain(A))
        if not rel <= 1e-5:
            raise RuntimeError(f"gj n={n}: rel Frobenius {rel:.3e}")
        out[f"gj_n{n}"] = rel
    for n, b in ((181, B), (512, 8)):
        A = _random_inverse_input(b, n, rng, dev)
        rel = _rel_fro(gj_inverse.schur_inverse(A),
                       gj_inverse.schur_inverse_plain(A))
        if not rel <= 1e-5:
            raise RuntimeError(f"schur n={n}: rel Frobenius {rel:.3e}")
        out[f"schur_n{n}"] = rel
    N_e, slots_e, empty, _ = rhs_edge_network()
    fused_e = FusedMassActionRHS(N_e, slots_e, dev)
    dd_e = DDContraction(N_e, dev)
    for b in (1, B):
        u_aug, k = _rhs_inputs(fused_e, rng, dev, b)
        du = fused_e(u_aug, k)
        rel = rhs_rel_err(fused_e, u_aug, k, du)
        r = (k * u_aug[:, fused_e._slots64].prod(dim=-1)).contiguous()
        same = bool(torch.equal(dd_e(r), du))
        if not (rel <= 1e-12 and same and bool((du[:, empty] == 0).all())):
            raise RuntimeError(f"rhs edge B={b}: rel {rel:.3e}, dd equal {same}")
        out[f"rhs_edge_b{b}"] = rel
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory with the other versions' sources")
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_compare: no CUDA card")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    cuda_build.load_libraries(NAMES)
    for name in NAMES:
        print(f"new {name}: " + " | ".join(
            ln.strip() for ln in cuda_build.build_info[name]["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    libs = _build_old(args.old) if args.old is not None else {}
    old_newton = _old_newton(libs["newton_solve"], dev) if libs else None
    systems = _newton_cases(dev, rng)
    result = {"card": card, "check": {**check(dev, rng),
                                      **check_newton(dev, systems, old_newton)}}
    print(f"check passed: {json.dumps(result['check'])}", flush=True)

    nets = {}
    for nc in (24, 60):
        sd, rd, _, _ = synthetic_pyrolysis_network(nc)
        net = build_mass_action(rd, sd.n, device=dev)
        fused = FusedMassActionRHS(net.N, net.reac_slots, dev)
        nets[nc] = (fused, DDContraction(net.N, dev),
                    *_rhs_inputs(fused, rng, dev))
    versions = {"new": dict(
        gj=gj_inverse.gj_inverse,
        fused={nc: v[0] for nc, v in nets.items()},
        dd={nc: v[1] for nc, v in nets.items()},
        newton=newton_solve.fused_newton_solve)}
    if libs:
        versions["old"] = dict(
            gj=_old_gj(libs["gj_inverse"]),
            fused={nc: _old_fused(libs["fused_rhs"], v[0])
                   for nc, v in nets.items()},
            dd={nc: _old_dd(libs["dd_contract"], v[1])
                for nc, v in nets.items()},
            newton=old_newton)

    cases = {}
    for n, b in ((73, B), (128, B), (53, B)):
        A = _random_inverse_input(b, n, rng, dev)
        cases[f"gj_n{n}_b{b}"] = (lambda v, A=A: (lambda: v["gj"](A)),
                                  bound(*inverse_work(b, n), "f32"))
    for n, b in ((181, B), (512, 8)):
        A = _random_inverse_input(b, n, rng, dev)
        cases[f"schur_n{n}_b{b}"] = (
            lambda v, A=A: (lambda: gj_inverse._schur(A, v["gj"])),
            bound(*inverse_work(b, n), "f32"))
    for nc, (fused, dd, u_aug, k) in nets.items():
        r = (k * u_aug[:, fused._slots64].prod(dim=-1)).contiguous()
        cases[f"fused_rhs_nc{nc}_b{B}"] = (
            lambda v, nc=nc, u_aug=u_aug, k=k: (lambda: v["fused"][nc](u_aug, k)),
            bound(*rhs_work(fused, B), "f64"))
        cases[f"dd_contract_nc{nc}_b{B}"] = (
            lambda v, nc=nc, r=r: (lambda: v["dd"][nc](r)),
            bound(*dd_work(dd, B), "f64"))
    sweeps, by_size = {}, {}
    for key, (M, J, b, c) in systems.items():
        taken = newton_sweeps(newton_solve.fused_newton_solve, M, J, b, c)
        sweeps[key] = {int(k): int((taken == k).sum()) for k in range(1, 5)}
        cs = newton_solve._device_plan(b.shape[1], b.shape[0], dev)
        by_size[key] = {
            size: graph_ms(lambda size=size, a=(M, J, b, c):
                           newton_solve.launch(*a, 4, size))
            for size in newton_solve.cluster_sizes(b.shape[1], dev)}
        held = {size: newton_solve.max_clusters(b.shape[1], size, dev)
                for size in by_size[key]}
        print(f"{key}: planned cluster of {cs}; lanes per sweep count "
              f"{sweeps[key]}; graph_ms by cluster size {by_size[key]}; "
              f"clusters the card holds at once, by size {held}", flush=True)
        cases[key] = (lambda v, a=(M, J, b, c): (lambda: v["newton"](*a)),
                      bound(*solve_work(*b.shape), "f32"))
    result["newton_sweeps"] = sweeps
    result["newton_graph_ms_by_cluster_size"] = by_size
    # the host time of a call: the old launch function called bare
    # (ctypes), the new one called bare at the planned cluster size, and
    # the new wrapper with its checks, in turns; the step loop is
    # host-bound, so a call that costs the host more shows end to end
    host = {}
    for key, a in systems.items():
        cs = newton_solve._device_plan(a[2].shape[1], a[2].shape[0], dev)
        calls = {"new_launch": lambda a=a, cs=cs: newton_solve.launch(
                     *a, 4, cs),
                 "new_wrapper": lambda a=a: newton_solve.fused_newton_solve(
                     *a)}
        if old_newton is not None:
            calls["old_launch"] = lambda a=a: old_newton(*a)
        runs = {v: [] for v in calls}
        for v in [*calls, *reversed(calls)]:
            runs[v].append(host_us(calls[v]))
        host[key] = runs
        print(f"{key}: host us per call {runs}", flush=True)
    result["newton_host_us"] = host

    order = ["old", "new", "new", "old"] if "old" in versions else ["new"]
    times = {}
    for case, (make, (b_ms, b_by)) in cases.items():
        runs = {v: [] for v in versions}
        for v in order:
            runs[v].append(graph_ms(make(versions[v])))
        times[case] = dict(bound_ms=b_ms, bound_by=b_by,
                           **{f"{v}_graph_ms": t for v, t in runs.items()})
        print(f"{case}: " + ", ".join(f"{v} {t}" for v, t in runs.items())
              + f" | bound {b_ms:.5f} ms ({b_by})", flush=True)
    result["times"] = times

    # which yardstick calls a CUDA graph can capture
    A = _random_inverse_input(B, 73, rng, dev)
    probe = {}
    for name, fn in (("linalg.inv_ex", lambda: torch.linalg.inv_ex(A)[0]),
                     ("linalg.inv", lambda: torch.linalg.inv(A))):
        try:
            probe[name] = graph_ms(fn)
        except RuntimeError as exc:
            probe[name] = f"not capturable: {str(exc).splitlines()[0][:120]}"
            torch.cuda.synchronize()
    result["library_capture"] = probe
    print(f"library capture: {probe}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
