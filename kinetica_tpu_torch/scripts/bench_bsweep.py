"""The batch-width sweep of the bench's solve on one card.

    python -m kinetica_tpu_torch.scripts.bench_bsweep [B ...] [--device cuda]
        [--out PATH]

The port of the JAX package's ``scripts/bench_bsweep.py``: for each B
(default 64 128 256 512 1024) the solve of
:mod:`kinetica_tpu_torch.scripts.bench` (its ``build()``, at
``KINETICA_BENCH_NC`` and its other settings) over B ramps at 40-60 K/s,
run once to build and warm up, then once timed. Member 0 (the 40 K/s ramp
at every B) is held to scipy-BDF within 1e-6 in max mole fraction, or the
program raises.

Prints one JSON line per B with the JAX script's fields: ``batch``,
``crn``, ``platform``, ``sweep_s``, ``compile_s`` (the first call less the
timed one), ``per_profile_ms``, ``profiles_per_sec``, ``ms_per_step``,
``steps_max``, ``steps_median``, ``mem`` (on the card
``torch.cuda.memory_allocated``, its peak ``max_memory_allocated`` in this
B's run, and the card's total from ``mem_get_info``), ``linsolve`` and
``chunk_mode``. An out-of-memory error at some B is that B's record, with
an ``error`` key, and the sweep stops there. The lines go to standard
output and, with ``--out PATH``, are appended to PATH; never to the JAX
side's ``scripts/bsweep_results.jsonl``.

Runs on the card unless ``--device cpu`` is given; without a card it
raises. Left out on purpose: the JAX compilation cache.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..examples import device_label
from . import bench

BATCHES = (64, 128, 256, 512, 1024)


def mem_stats(device) -> dict:
    if device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": total, "bytes_free": free}


def run_batch(batch: int, device, reference) -> dict:
    """One B: build, first call, timed call -> the record."""
    sd, rd, calc, conditions_list, pars = bench.build(device, batch=batch)
    problem = bench.ensemble(sd, rd, calc, conditions_list, pars, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ens, first_s, (sweep_s,) = bench.timed_sweeps(problem, conditions_list,
                                                  device, 1)
    err = bench.mole_err(ens.u[0, -1], reference)
    if not err <= bench.GATE:
        raise RuntimeError(f"B={batch}: member 0 is {err:.3e} from scipy-BDF "
                           f"in max mole fraction (> {bench.GATE})")
    steps_max, steps_median = bench.steps_of(ens)
    bench.log(f"B={batch}: member 0 vs scipy-BDF {err:.2e}")
    return {
        "batch": batch, "crn": f"{rd.nr}rxn/{sd.n}sp",
        "platform": bench.platform(device), "sweep_s": sweep_s,
        "compile_s": first_s - sweep_s,
        "per_profile_ms": sweep_s * 1e3 / batch,
        "profiles_per_sec": batch / sweep_s,
        "ms_per_step": sweep_s * 1e3 / steps_max,
        "steps_max": steps_max, "steps_median": steps_median,
        "mem": mem_stats(device), "linsolve": pars.linsolve,
        "chunk_mode": problem.chunk_mode}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batches", nargs="*", type=int, default=list(BATCHES),
                   help="the batch widths (default 64 128 256 512 1024)")
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    p.add_argument("--out", default=None,
                   help="also append each record to this JSON-lines file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    bench.log(f"device {device_label(device)}")
    # member 0 is the 40 K/s ramp at every B: one reference for the sweep
    sd, rd, calc, conditions_list, pars = bench.build(device, batch=1)
    _, reference = bench.cpu_baseline_seconds(sd, rd, calc,
                                              conditions_list[0], pars,
                                              best_of=1)
    records = []
    for b in args.batches:
        try:
            rec = run_batch(b, device, reference)
        except torch.cuda.OutOfMemoryError as exc:
            rec = {"batch": b, "error": f"{type(exc).__name__}: {exc}"}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            bench.append_json(args.out, rec)
        if "error" in rec:
            break
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
