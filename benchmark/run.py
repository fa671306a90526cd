"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Needs a CUDA card (exits 2 without one, or
with fewer cards than the cell asks for). With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the traced solve's device busy time
and ``breakdown``. The numbers compared with the reference and their
limits are the last lines of standard error and the last key of the
result line. Exits 3, and prints no result, if ``jax``, ``jaxlib``,
``flax`` or ``kinetica_tpu`` were loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kinetica_tpu")


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    name compared whole (``kinetica_tpu_torch`` is not ``kinetica_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from .harness import Spec, run_cell
    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda:0")
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
