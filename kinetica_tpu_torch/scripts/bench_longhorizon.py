"""BASELINE config 3: the 1e5 s variable-T sweep on one card.

    python -m kinetica_tpu_torch.scripts.bench_longhorizon [--device cuda]

The port of the JAX package's ``scripts/bench_longhorizon.py``, its
settings unchanged: the bench's network (``KINETICA_BENCH_NC``, default
24: 1095 reactions, 73 species) under B = ``KINETICA_BENCH_BATCH``
(default 64) slow ramps from 500 K at 4e-3 to 6e-3 K/s over
``KINETICA_BENCH_TF`` (default 1e5) s, in ``KINETICA_BENCH_CHUNKS``
(default 40) chunks with one save a chunk,
``low_k_cutoff="auto"``, continuous rates, the solver's default
tolerances (rtol 1e-8, atol 1e-10). It is a cell of the bench's solve, so
it shares :func:`kinetica_tpu_torch.scripts.bench.build`. A smaller
``KINETICA_BENCH_TF`` with ``KINETICA_BENCH_CHUNKS`` cut alike (2.5e3 s a
chunk) runs the first chunks of the same solve.

The sweep runs twice, the first call building the kernels and warming up,
the second timed. Prints what the JAX script prints: ms per profile, steps
max and median, the carbon drift of the final states, the lane spread of
the step counts and its correlation with the ramp rate, the CPU time of
scipy-BDF over the same chunks in chunkwise local time (a global-time
solve underflows its step near t ~ 6e4 s), best of 3, and the error of
member 0 against it. Member 0 must lie within 1e-6 of that reference in
max mole fraction, or the program raises after printing it.

Runs on the card unless ``--device cpu`` is given; without a card it
raises. It writes no file. Left out on purpose: the JAX compilation cache.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..examples import device_label
from . import bench

TF = 1e5
RAMP = (4e-3, 6e-3)
N_CHUNKS = 40


def carbons(name: str) -> int:
    return 0 if name in ("Hr", "H2") else int(name[1:].rstrip("re"))


def main(argv=None) -> dict:
    from ..solving.solve_utils import make_u0
    from ..testing.cpu_reference import scipy_bdf_chunked_baseline

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    s = bench.settings()
    nc, B = s["n_carbons"], s["batch"]
    n_chunks = int(os.environ.get("KINETICA_BENCH_CHUNKS", str(N_CHUNKS)))
    tf = float(os.environ.get("KINETICA_BENCH_TF", str(TF)))
    bench.log(f"device {device_label(device)}")
    sd, rd, calc, conditions_list, pars = bench.build(
        device, batch=B, tf=tf, ramp=RAMP, chunkstep=tf / n_chunks,
        save_interval=tf / n_chunks, low_k_cutoff="auto")
    problem = bench.ensemble(sd, rd, calc, conditions_list, pars, device)
    ens, warm, (dt,) = bench.timed_sweeps(problem, conditions_list, device, 1)

    cvec = np.array([carbons(sd.toStr[i]) for i in range(sd.n)])
    drift = float(np.abs(ens.u[:, -1] @ cvec - nc).max() / nc)
    steps = np.asarray(ens.stats["n_steps"])
    out = {"batch": B, "tf": tf, "n_chunks": n_chunks,
           "per_profile_ms": dt / B * 1e3,
           "sweep_s": dt, "warm_s": warm, "steps_max": int(steps.max()),
           "steps_median": int(np.median(steps)), "carbon_drift": drift}
    horizon = f"{tf:.3g}".replace("e+0", "e")     # "1e5", as the JAX line
    print(f"{horizon}s sweep ({n_chunks} chunks): {dt / B * 1e3:.1f} "
          f"ms/profile (warm incl compile {warm:.0f}s); steps max="
          f"{int(steps.max())} "
          f"med={int(np.median(steps))}; carbon drift {drift:.2e}", flush=True)
    if steps.size == B and B > 2:
        # the lane spread is chemistry if the step counts rise with the
        # ramp rate (a hotter ramp turns more over), not the controller
        rates = np.linspace(RAMP[0], RAMP[1], B)
        corr = float(np.corrcoef(rates, steps)[0, 1])
        out.update(steps_min=int(steps.min()), corr_steps_rate=corr)
        print(f"lane spread: steps min={int(steps.min())} max="
              f"{int(steps.max())} (x{steps.max() / max(steps.min(), 1):.2f})"
              f"; corr(steps, ramp rate) = {corr:+.3f}", flush=True)

    cpu_dt, cpu_final = scipy_bdf_chunked_baseline(
        sd, rd, calc, conditions_list[0].get_profile("T"), pars.tspan,
        make_u0(sd, pars), pars.reltol, pars.abstol, n_chunks=n_chunks,
        best_of=3)
    err = bench.mole_err(ens.u[0, -1], cpu_final)
    out.update(cpu_baseline_s=cpu_dt, max_molefrac_err=err)
    print(f"CPU BDF single profile: {cpu_dt:.2f}s -> per-profile speedup "
          f"{cpu_dt / (dt / B):.1f}x; max mole-frac err vs CPU {err:.2e}",
          flush=True)
    if not err <= bench.GATE:
        raise RuntimeError(f"member 0 is {err:.3e} from the chunked "
                           f"scipy-BDF in max mole fraction (> {bench.GATE})")
    return out


if __name__ == "__main__":
    main()
