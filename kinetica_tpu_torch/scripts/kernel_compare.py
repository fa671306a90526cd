"""Check the Gauss-Jordan, fused-RHS and contraction kernels at the main
path's shapes, and time them against another version of their sources.

    python -m kinetica_tpu_torch.scripts.kernel_compare [--old DIR] [--out FILE]

Builds ``gj_inverse``, ``fused_rhs`` and ``dd_contract`` from the
checkout (printing ``ptxas`` registers and spills), holds each against its
plain version at the shapes of ``chip_smoke.py`` (GJ at n = 73 and 128,
B = 64; the block-Schur inverse at n = 181, B = 64 and n = 512, B = 8; the
RHS and the contraction on ``synthetic_pyrolysis_network(24)`` and
``(60)`` at B = 64) and on the edge cases of
:mod:`kinetica_tpu_torch.testing.kernel_cases`, then times each shape by
:func:`~kinetica_tpu_torch.testing.device_timing.graph_ms`.

With ``--old DIR`` (a directory holding other versions of
``gj_inverse.cu``, ``fused_rhs.cu``, ``dd_contract.cu`` and the headers
they include, with the same C launch functions, e.g. a parent commit's
``kinetica_tpu_torch/csrc`` unpacked by ``git archive``), those are built
too and every shape is timed old, new, new, old in one process. The
result is one JSON line on standard output, and in ``--out FILE`` if
given.
Inputs are random, made from a seed: the kernels' times do not depend on
the values.
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
from ..ops import cuda_build, gj_inverse
from ..ops.dd_contract import DDContraction
from ..ops.fused_rhs import FusedMassActionRHS
from ..testing.device_timing import (bound, dd_work, graph_ms, inverse_work,
                                     rhs_work)
from ..testing.kernel_cases import (GJ_EDGE_WIDTHS, gj_edge_cases,
                                    rhs_edge_network, rhs_rel_err)
from ..testing.synthetic import synthetic_pyrolysis_network

NAMES = ("gj_inverse", "fused_rhs", "dd_contract")
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
    result = {"card": card, "check": check(dev, rng)}
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
        dd={nc: v[1] for nc, v in nets.items()})}
    if args.old is not None:
        libs = _build_old(args.old)
        versions["old"] = dict(
            gj=_old_gj(libs["gj_inverse"]),
            fused={nc: _old_fused(libs["fused_rhs"], v[0])
                   for nc, v in nets.items()},
            dd={nc: _old_dd(libs["dd_contract"], v[1])
                for nc, v in nets.items()})

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
