"""BASELINE config 5: kinetics-gated iterative exploration, end to end.

    python -m kinetica_tpu_torch.scripts.bench_explore [B] [--device cuda]
        [--out PATH]

The port of the JAX package's ``scripts/bench_explore.py``: the reference's
product loop alternates stochastic mechanism sampling (the native
``cde_lite`` sampler) with a kinetic solve of the network so far, one
batched ``EnsembleProblem`` gate over B (default 64) ramps a level, and
picks the next level's seeds from the solution. The setup is
:func:`kinetica_tpu_torch.testing.explore_config.config5`, the same as
``chip_smoke.py`` phase 17 (``random.seed(0)`` first, as there).

Prints one JSON line with the JAX record's schema: per level (``per_level``,
the explore method's ``timings``) the sampling and ingest wall time
``explore_s``, the gate's solve ``solve_s`` and the checkpoint and seed
selection ``seeds_s`` (the port adds each gate's ``n_steps_max`` and
``host_syncs``); the total wall time, the solve and explore totals, and
the interleave overhead, the total less the sum of the phases. The line
goes to standard output and, with ``--out PATH``, is appended to PATH;
never to the JAX side's ``scripts/explore_results.jsonl``. The run's files
go to a temporary directory that is removed at the end.

Runs on the card unless ``--device cpu`` is given; without a card it
raises. Left out on purpose: the JAX compilation cache.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import tempfile
import time

from ..device import resolve_device
from ..examples import device_label
from . import bench


def main(argv=None) -> dict:
    from ..exploration import explore_network
    from ..exploration.cde_lite import build_cde_lite
    from ..testing.explore_config import config5

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=64,
                   help="ramps in each level's gate (default 64)")
    p.add_argument("--device", default="cuda",
                   help="the device to solve on (default: cuda, the card)")
    p.add_argument("--out", default=None,
                   help="also append the record to this JSON-lines file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if build_cde_lite() is None:
        raise SystemExit("g++ unavailable: cannot build the native sampler")
    bench.log(f"device {device_label(device)}")

    random.seed(0)
    with tempfile.TemporaryDirectory(prefix="kinetica_bench_explore_") as work:
        em, sm, _ = config5(work, batch=args.batch, device=device)
        t0 = time.perf_counter()
        res = explore_network(em, sm, savedir=os.path.join(work, "out"),
                              device=device)
        bench.sync(device)
        total_s = time.perf_counter() - t0
    timings = em.timings
    phase_sum = sum(t["explore_s"] + t["solve_s"] + t["seeds_s"]
                    for t in timings)
    rec = {
        "config": "baseline-5-iterative-exploration",
        "platform": bench.platform(device),
        "batch": args.batch,
        "levels": len(timings),
        "final_species": res.sd.n,
        "final_reactions": res.rd.nr,
        "total_s": total_s,
        "solve_total_s": sum(t["solve_s"] for t in timings),
        "explore_total_s": sum(t["explore_s"] for t in timings),
        "interleave_overhead_s": total_s - phase_sum,
        "per_level": timings,
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        bench.append_json(args.out, rec)
    return rec


if __name__ == "__main__":
    main()
