"""The 1e5 s horizon (BASELINE config 3) on the CPU: the port's steps
against the JAX package's.

``kinetica_tpu_torch.scripts.bench_longhorizon`` runs through its ``main``
with ``--device cpu`` at ``KINETICA_BENCH_NC=6`` over the full horizon
(its 40 chunks of 2.5e3 s, its settings unchanged), at two batch sizes:
B = 4 and B = 8 spread their ramps over the same rates, so the two draw
different ramps. The Newton matrices of the slow ramps turn singular in
f32 past ~2e4 s, where a Gauss-Jordan inverse that eliminates otherwise
than the reference's meets exactly cancelled pivots and Newton fails (the
horizon then takes several times the steps), so a cut horizon cannot show
it.

The JAX package's steps are a record (``testing/longhorizon_record.json``):
``scripts/bench_longhorizon.py`` at the same sizes, each lane's steps, by
three routes:

* "auto", as published: the f64 LU solve on a CPU;
* "inv_gated": the Gauss-Jordan route (its Pallas kernel in interpret
  mode) with the JAX package's CPU Newton-Schulz schedule (pair residual,
  adaptive refinement);
* "inv_gated_accel": the same route with the accelerator schedule the
  port runs (``KINETICA_NS_RESIDUAL=f64dot``, ``KINETICA_REFINE=unroll:2``);
* "inv_gated_accel_gj64": that route with the factor's Gauss-Jordan
  inverse taken by the port's f64 elimination (``gj_inverse_plain`` of
  the equilibrated f32 matrix cast to f64, rounded to f32, through
  ``jax.pure_callback``), where the JAX package eliminates in f32: the
  port's algorithm, a difference on purpose (``ops/linalg.py``), run by
  the JAX package.

The routes differ only in rounding, and that moves a lane's steps a lot:
at B = 4 the JAX package's own lanes take 772-876 steps by LU and
799-1160 by "inv_gated" (one lane 876 against 1160), and steps max moves
17% between the two schedules of one elimination ("inv_gated" against
"inv_gated_accel"). So the port's steps median is held within 10% of its
own algorithm's, "inv_gated_accel_gj64"; steps max and median together
within 10% of one and the same route; and both within the routes' spread
widened by 10%. Member 0 must lie within 1e-6 of the chunked scipy-BDF.

``python tests/test_torch_longhorizon_steps.py`` runs the JAX script at
both sizes by every route and rewrites the record (about a minute);
``... NC B`` runs it at other sizes and only prints the steps (nc=24,
B=8 takes tens of minutes on a CPU).
"""
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
RECORD = REPO / "kinetica_tpu_torch" / "testing" / "longhorizon_record.json"
NC = "6"
BATCHES = ("4", "8")
ACCEL = {"KINETICA_NS_RESIDUAL": "f64dot", "KINETICA_REFINE": "unroll:2"}
# route -> (linsolve "auto" resolves to, environment of the JAX run, the
# factor's inverse by the port's f64 elimination)
ROUTES = {
    "auto": ("auto", {}, False),
    "inv_gated": ("inv_gated", {}, False),
    "inv_gated_accel": ("inv_gated", ACCEL, False),
    "inv_gated_accel_gj64": ("inv_gated", ACCEL, True),
}
SAME_ALGORITHM = "inv_gated_accel_gj64"


def _stats(steps) -> tuple[int, int]:
    steps = np.asarray(steps)
    return int(steps.max()), int(np.median(steps))


@pytest.mark.parametrize("batch", BATCHES)
def test_port_takes_the_jax_steps(monkeypatch, batch):
    from kinetica_tpu_torch.scripts import bench_longhorizon as lh
    torch.set_num_threads(1)
    monkeypatch.setenv("KINETICA_BENCH_NC", NC)
    monkeypatch.setenv("KINETICA_BENCH_BATCH", batch)
    for k in ("KINETICA_BENCH_TF", "KINETICA_BENCH_CHUNKS"):
        monkeypatch.delenv(k, raising=False)
    rec = json.loads(RECORD.read_text())
    assert rec["nc"] == NC and sorted(rec["steps"][batch]) == sorted(ROUTES)
    jax = {r: _stats(s) for r, s in rec["steps"][batch].items()}
    out = lh.main(["--device", "cpu"])
    assert out["tf"] == 1e5 and out["n_chunks"] == 40
    assert out["batch"] == int(batch)
    assert out["max_molefrac_err"] <= 1e-6
    port = (out["steps_max"], out["steps_median"])
    print(f"B={batch}: port steps max/median {port}, the JAX package's {jax}")
    ref = jax[SAME_ALGORITHM][1]
    assert abs(port[1] - ref) <= 0.1 * ref, (port, jax)
    assert any(all(abs(port[i] - v[i]) <= 0.1 * v[i] for i in (0, 1))
               for v in jax.values()), (port, jax)
    for i, what in enumerate(("max", "median")):
        lo = min(v[i] for v in jax.values())
        hi = max(v[i] for v in jax.values())
        assert 0.9 * lo <= port[i] <= 1.1 * hi, (what, port, jax)


def _port_gj64(As, interpret=False):
    """The port's f64 Gauss-Jordan inverse of a JAX batch of f32 matrices,
    rounded to f32 (the Newton factor's, ``ops/linalg.py``)."""
    import jax
    from kinetica_tpu_torch.ops.gj_inverse import gj_inverse_plain

    def inverse(A):
        A = np.asarray(A, dtype=np.float64)
        n = A.shape[-1]
        M = gj_inverse_plain(torch.from_numpy(A.reshape(-1, n, n))).numpy()
        return M.reshape(A.shape).astype(np.float32)
    return jax.pure_callback(inverse, jax.ShapeDtypeStruct(As.shape, As.dtype),
                             As, vmap_method="expand_dims")


def _jax_steps(route: str) -> list[int]:
    """Each lane's steps of the JAX script's solve by ``route``."""
    import kinetica_tpu.ops.bdf as jbdf
    import kinetica_tpu.ops.linalg as jlinalg
    linsolve, env, gj64 = ROUTES[route]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    resolve, gj_inverse = jbdf.resolve_linsolve, jlinalg.gj_inverse
    jbdf.resolve_linsolve = lambda m, ns: resolve(
        linsolve if m == "auto" else m, ns)
    if gj64:
        jlinalg.gj_inverse = _port_gj64
    try:
        g = runpy.run_path(str(REPO / "scripts" / "bench_longhorizon.py"),
                           run_name="__main__")
    finally:
        jbdf.resolve_linsolve, jlinalg.gj_inverse = resolve, gj_inverse
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return [int(s) for s in np.asarray(g["ens"].stats["n_steps"])]


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    nc, batches = NC, BATCHES
    if len(sys.argv) == 3:
        nc, batches = sys.argv[1], (sys.argv[2],)
    sys.argv = [str(REPO / "scripts" / "bench_longhorizon.py")]
    os.environ["KINETICA_BENCH_NC"] = nc
    steps = {}
    for b in batches:
        os.environ["KINETICA_BENCH_BATCH"] = b
        steps[b] = {route: _jax_steps(route) for route in ROUTES}
    rec = json.dumps({
        "nc": nc, "steps": steps,
        "made_by": "python tests/test_torch_longhorizon_steps.py",
        "script": "scripts/bench_longhorizon.py", "platform": "cpu"},
        indent=1) + "\n"
    if (nc, batches) == (NC, BATCHES):
        RECORD.write_text(rec)
    print(rec)
