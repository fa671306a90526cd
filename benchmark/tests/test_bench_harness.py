"""The harness on the CPU at a small size: cells, mixes, configurations
and metrics found by name, the result line's keys, the traffic generator,
the trace's reduction, the command's refusal without a card."""
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, trace, traffic
from benchmark.harness import Spec, run_cell

from conftest import REPO, SINGLE, TINY_CONFIG

CPU = torch.device("cpu")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, trace_on=False, seed=2 ** 31 + 7):
    return run_cell(Spec(root), cell, seed, 0.01, trace_on, CPU,
                    time.perf_counter(), log=lambda m: None)


def test_the_repositorys_cells_resolve_to_files():
    spec = Spec(REPO)
    for name, w in spec.workloads.items():
        config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert config["name"] == w["config"] and mix["name"] == w["traffic"]
        assert spec.module("entries", mix["entry"]).make
        assert check.load_limits(REPO, name)["failed_lanes"]["limit"] == 0
        for kind, folder in (("end_to_end", "end_to_end"),
                             ("per_layer", "metrics")):
            assert spec.metrics(name, kind), (name, kind)
            for m in spec.metrics(name, kind):
                assert callable(spec.module(folder, m["name"]).read)


def test_result_line_keys_and_metrics(tiny_root):
    result = run(tiny_root, "tiny_b4")
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] % 4 == 0
    assert set(result["metrics"]) == {"profiles_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)


def test_window_ends_on_whole_groups(tiny_root):
    """The single cell's first solve outlasts the window, and the window
    holds the rest of its group (``strata`` 2) all the same."""
    assert run(tiny_root, "tiny_single")["attempted"] == 2


def test_traced_run_reports_per_layer_metrics(tiny_root):
    result = run(tiny_root, "tiny_b4", trace_on=True)
    names = set(result["metrics"])
    # on the CPU no kernel runs: the rooflines find nothing to read
    assert {"bdf.ms_per_step", "bdf.steps_max", "host_sync.reads_per_step",
            "linalg.factors_per_lane_step", "device.idle_pct"} <= names
    assert not any(n.endswith("_roofline") for n in names)
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_cell_config_mix_and_metric_are_data_alone(tiny_root):
    """A cell, a configuration, a mix and a per-layer metric added as new
    files and new entries of BENCHMARK.json, with no file edited."""
    bench = tiny_root / "benchmark"
    config = dict(TINY_CONFIG, name="tiny_nc8",
                  network=dict(TINY_CONFIG["network"], n_carbons=8),
                  reactions=183, species=25, initial={"C8": 1.0})
    (bench / "configs" / "tiny_nc8.json").write_text(json.dumps(config))
    mix = dict(SINGLE, name="tiny_single_fast",
               ramp=dict(SINGLE["ramp"], rate_lo=55.0))
    (bench / "traffic" / "tiny_single_fast.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny_new.json").write_text(json.dumps(
        {"max_molefrac_err": {"limit": 1e-7}, "failed_lanes": {"limit": 0}}))
    (bench / "metrics" / "bdf.solves.py").write_text(
        "def read(ctx):\n    return len(ctx.solves)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_nc8", "source": "tests",
                            "file": "benchmark/configs/tiny_nc8.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny_new", "config": "tiny_nc8",
                              "traffic": "tiny_single_fast", "chips": 1,
                              "why": "tests"})
    spec["per_layer"].append({"name": "bdf.solves", "unit": "solves",
                              "better": "higher", "source": "host_clock",
                              "layer": "BDF loop (ops/bdf.py)",
                              "moves": "profiles_per_s",
                              "workloads": ["tiny_new"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run(tiny_root, "tiny_new", trace_on=True)
    assert result["correct"]
    assert result["metrics"]["bdf.solves"]["value"] >= 1
    assert "bdf.solves" not in run(tiny_root, "tiny_single",
                                   trace_on=True)["metrics"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3, 2 ** 70])
def test_ramps_are_stratified_and_seeded(seed):
    mix = json.loads((REPO / "benchmark" / "traffic" /
                      "ramp_sweep_b64.json").read_text())
    a, b = traffic.Ramps(mix, seed), traffic.Ramps(mix, seed)
    first = a.next_batch()
    np.testing.assert_array_equal(first, b.next_batch())
    # one rate in each of the 64 slices of [40, 60]
    assert sorted(np.floor((first - 40.0) / 20.0 * 64).astype(int)) == \
        list(range(64))
    second = a.next_batch()
    assert not np.intersect1d(first, second).size
    # another seed: the same ramps in another order
    other = traffic.Ramps(mix, seed + 1)
    o1, o2 = other.next_batch(), other.next_batch()
    np.testing.assert_array_equal(np.sort(o1), np.sort(first))
    np.testing.assert_array_equal(np.sort(o2), np.sort(second))
    assert not np.array_equal(o1, first)
    single = traffic.Ramps(SINGLE, seed)
    assert [single.next_batch().shape for _ in range(3)] == [(1,)] * 3
    # a group of ``strata`` (2) ramps is whole after every second solve
    assert not single.whole
    single.next_batch()
    assert single.whole and a.whole


def _event(name, kind, start, dur, typed=True):
    """An event as torch 2.13 gives it (``typed``), or as torch 2.11 does,
    without ``activity_type``."""
    ev = SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                         duration_ns=lambda: dur,
                         device_type=lambda: "DeviceType.CUDA" if kind in (
                             "kernel", "gpu_memcpy", "gpu_memset")
                         else "DeviceType.CPU")
    if typed:
        ev.activity_type = lambda: kind
    return ev


@pytest.mark.parametrize("typed", [True, False])
def test_trace_reduction_by_hand(typed):
    events = [
        _event(trace.SPAN, "user_annotation", 1000, 1000),
        _event("aten::mul", "cpu_op", 1000, 300),
        _event("cudaLaunchKernel", "cuda_runtime", 1100, 50),
        _event("(anonymous namespace)::fused_rhs_kernel(double const*)",
               "kernel", 1200, 200),
        _event("cudaLaunchKernel", "cuda_runtime", 1300, 50),
        _event("gj_inverse_kernel(float*)", "kernel", 1350, 150),
        _event("Memcpy DtoH", "gpu_memcpy", 1700, 100),
        _event("aten::item", "cpu_op", 1650, 300),
        _event("late_kernel", "kernel", 2500, 10),
    ]
    events = [_event(e.name(), e.activity_type(), e.start_ns(),
                     e.duration_ns(), typed)
              for e in events]
    tr = trace.reduce(events)
    assert tr.window_s == pytest.approx(1e-6)
    # busy: [1200, 1500) and [1700, 1800)
    assert tr.busy_s == pytest.approx(400e-9)
    assert tr.launches == 2
    assert [trace.short_name(k.name) for k in tr.kernels] == \
        ["fused_rhs_kernel", "gj_inverse_kernel"]
    gaps = dict(tr.idle_gaps)
    # [1000, 1200) in aten::mul, [1500, 1700) after it ended, [1800, 2000)
    # in aten::item
    assert gaps["aten::mul"] == pytest.approx(200e-9)
    assert gaps["host (no op open)"] == pytest.approx(200e-9)
    assert gaps["aten::item"] == pytest.approx(200e-9)
    assert dict(tr.device_ops)["fused_rhs_kernel"] == pytest.approx(200e-9)


def test_roofline_readers_by_hand():
    from benchmark.roofline import (bound_s, inverse_work, rhs_work,
                                    solve_work)
    spec = Spec(REPO)
    shape = SimpleNamespace(batch=64, ns=181, nr=4473, nnz=1000, arity=2)
    kernels = [trace.Kernel("(anonymous namespace)::fused_rhs_kernel(int)",
                            0, 1000),
               trace.Kernel("gj_inverse_kernel(float*)", 0, 2000),
               trace.Kernel("gj_inverse_kernel(float*)", 0, 2000),
               trace.Kernel("newton_solve_kernel", 0, 500)]
    traced = SimpleNamespace(attempts=1, n_lu=np.array([3, 0, 2]))
    ctx = SimpleNamespace(shape=shape, trace=SimpleNamespace(kernels=kernels),
                          traced=traced)

    def read(name):
        return spec.module("metrics", name).read(ctx)
    assert read("fused_rhs_roofline") == pytest.approx(
        100 * bound_s(*rhs_work(64, 181, 4473, 2, 1000), "f64") / 1e-6)
    # 181 species: Gauss-Jordan inverts the 128 and 53 diagonal blocks
    assert read("gj_inverse_roofline") == pytest.approx(
        100 * 5 * (bound_s(*inverse_work(1, 128), "f32")
                   + bound_s(*inverse_work(1, 53), "f32")) / 4e-6)
    assert read("newton_solve_roofline") == pytest.approx(
        100 * bound_s(*solve_work(64, 181), "f32") / 0.5e-6)
    traced.attempts = 2     # a retried batch: lanes a call unknown
    assert read("fused_rhs_roofline") is None
    assert read("gj_inverse_roofline") is None
    traced.attempts, ctx.trace.kernels = 1, []
    assert read("newton_solve_roofline") is None


def test_check_sample_holds_the_hardest_lane():
    answers = [(np.arange(4.0), None, None, np.array([5, 9, 7, 1])),
               (np.arange(4.0), None, None, np.array([1, 1, 1, 1]))]
    lanes = check.pick(answers, 3, seed=11)
    assert lanes[0] == (0, 1) and len(set(lanes)) == 3
    assert lanes == check.pick(answers, 3, seed=11)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run",
                           "--workload", "nc24_ramp_b64", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
