"""``benchmark/spans.py`` and the readers of the program's solve record, by
hand: the device's idle gaps split among the host's phases by overlap,
the five shares adding up to the kernels-only idle share of the record,
the counters a step, and no reading without a record of the traced solve
or without a trace."""
import time
from types import SimpleNamespace

import pytest

from benchmark import spans
from benchmark.harness import Spec
from benchmark.trace import Kernel

from conftest import REPO

IDLE = {"device.idle_setup_pct": "setup", "device.idle_step_pct": "bdf.step",
        "device.idle_newton_pct": "bdf.newton",
        "device.idle_factor_pct": "linalg.factor",
        "device.idle_reads_pct": "host_sync.read"}
COUNTED = ("bdf.newton_iters_per_step", "linalg.lanes_per_factor",
           "linalg.refine_sweeps_per_step")

# (id, parent, name, start, end): one solve, one step
SPANS = [(0, -1, "ensemble.solve", 0, 1000),
         (1, 0, "ensemble.attempt", 50, 950),
         (2, 1, "bdf.solve", 60, 940),
         (3, 2, "bdf.init", 60, 200),
         (4, 3, "linalg.factor", 100, 180),
         (5, 2, "host_sync.read", 200, 220),
         (6, 2, "bdf.step", 220, 900),
         (7, 6, "bdf.predict", 220, 300),
         (8, 6, "linalg.factor", 300, 400),
         (9, 8, "host_sync.read", 300, 330),
         (10, 6, "bdf.newton", 400, 700),
         (11, 10, "bdf.newton_iter", 400, 550),
         (12, 10, "bdf.newton_iter", 550, 650),
         (13, 10, "host_sync.read", 650, 700),
         (14, 6, "bdf.control", 700, 880),
         (15, 6, "host_sync.read", 880, 900)]
KERNELS = [(0, 30), (120, 150), (250, 260), (350, 500), (600, 620),
           (800, 810), (1100, 1200)]
# idle [30, 120) [150, 250) [260, 350) [500, 600) [620, 800) [810, 1000)
# of the outermost span, split by the innermost span open over each piece
IDLE_NS = {"setup": 20 + 10 + 40 + 20 + 40 + 10 + 50,
           "linalg.factor": 20 + 30 + 20,
           "host_sync.read": 20 + 30 + 50 + 20,
           "bdf.step": 30 + 40 + 100 + 70,
           "bdf.newton": 100 + 30}
WINDOW_NS = 2000
COUNTERS = {"bdf.newton_iters": 30, "linalg.refine_sweeps": 12,
            "linalg.factor_lanes": 40, "linalg.factor_builds": 4}


def _record(spans_=SPANS, counters=COUNTERS):
    return SimpleNamespace(id=7, dropped=0, counters=dict(counters), spans=[
        SimpleNamespace(id=i, parent=p, name=n, start_ns=a, end_ns=b)
        for i, p, n, a, b in spans_])


def _ctx(kernels=KERNELS, steps_max=10):
    tr = SimpleNamespace(window_s=WINDOW_NS * 1e-9, kernels=[
        Kernel("k", a, b - a) for a, b in kernels])
    return SimpleNamespace(trace=tr, traced=SimpleNamespace(
        steps_max=steps_max))


@pytest.fixture
def last_solve(monkeypatch):
    """Sets what the program's ``profiling.last_solve()`` returns."""
    from kinetica_tpu_torch.utils import profiling

    def set_record(rec):
        monkeypatch.setattr(profiling, "last_solve", lambda: rec)
    return set_record


def _read(name, ctx):
    return Spec(REPO).module("metrics", name).read(ctx)


def test_idle_split_by_overlap():
    rec = _record()
    kernels = _ctx().trace.kernels
    assert spans.gaps(kernels, 0, 1000) == [
        (30, 120), (150, 250), (260, 350), (500, 600), (620, 800),
        (810, 1000)]
    segs = spans.segments(rec.spans)
    assert segs[0] == (0, 50, "setup") and segs[-1] == (950, 1000, "setup")
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    # the gap [620, 800) spans the Newton iteration, its read and control
    assert [s for s in segs if s[0] < 800 and s[1] > 620] == [
        (550, 650, "bdf.newton"), (650, 700, "host_sync.read"),
        (700, 880, "bdf.step")]
    assert spans.idle_by_phase(kernels, rec.spans) == IDLE_NS


def test_idle_readers_sum_to_the_kernels_only_idle_share(last_solve):
    last_solve(_record())
    ctx = _ctx()
    shares = {name: _read(name, ctx) for name in IDLE}
    for name, phase in IDLE.items():
        assert shares[name] == pytest.approx(100 * IDLE_NS[phase] / WINDOW_NS)
    busy = 30 + 30 + 10 + 150 + 20 + 10
    assert sum(shares.values()) == pytest.approx(
        100 * (1000 - busy) / WINDOW_NS)


def test_counter_readers(last_solve):
    last_solve(_record())
    ctx = _ctx()
    assert _read("bdf.newton_iters_per_step", ctx) == pytest.approx(3.0)
    assert _read("linalg.refine_sweeps_per_step", ctx) == pytest.approx(1.2)
    assert _read("linalg.lanes_per_factor", ctx) == pytest.approx(10.0)
    last_solve(_record(counters=dict(COUNTERS, **{"linalg.factor_builds":
                                                  0})))
    assert _read("linalg.lanes_per_factor", ctx) is None


@pytest.mark.parametrize("case", ["no trace", "no kernels", "no record",
                                  "another solve", "older program"])
def test_no_reading_without_a_record_of_the_traced_solve(last_solve,
                                                         monkeypatch, case):
    ctx = _ctx()
    last_solve(_record())
    if case == "no trace":
        ctx.trace = None
    elif case == "no kernels":
        ctx.trace.kernels = []
    elif case == "no record":
        last_solve(None)
    elif case == "another solve":
        ctx = _ctx(kernels=[(5000, 6000)])
    else:
        from kinetica_tpu_torch.utils import profiling
        monkeypatch.delattr(profiling, "last_solve")
    for name in list(IDLE) + list(COUNTED):
        assert _read(name, ctx) is None, name


def test_the_programs_record_is_read():
    """A record the program made (spans around sleeps, recording switched
    on by ``Timings``), read against kernels laid over it by hand."""
    from kinetica_tpu_torch.utils import profiling
    profiling.Timings.enable(True)
    try:
        with profiling.span("ensemble.solve"):
            with profiling.span("bdf.step"):
                time.sleep(0.002)
                with profiling.span("host_sync.read", site="bdf.loop"):
                    time.sleep(0.002)
    finally:
        profiling.Timings.enable(False)
        profiling.Timings.reset()
    rec = profiling.last_solve()
    step, read = rec.spans[1], rec.spans[2]
    # one kernel over the step's first half: the rest of the step idles
    k0 = step.start_ns
    k1 = k0 + (read.start_ns - k0) // 2
    ctx = _ctx(kernels=[(k0, k1)])
    ctx.trace.window_s = (rec.top.end_ns - rec.top.start_ns) * 1e-9
    got = spans.idle_by_phase(ctx.trace.kernels, rec.spans)
    assert got["host_sync.read"] == read.end_ns - read.start_ns
    assert got["bdf.step"] == (read.start_ns - k1) + (step.end_ns
                                                      - read.end_ns)
    assert sum(_read(name, ctx) for name in IDLE) == pytest.approx(
        100 * sum(got.values()) / (rec.top.end_ns - rec.top.start_ns))


def test_the_metrics_are_listed_for_their_cells():
    spec = Spec(REPO)
    per_layer = {m["name"]: m for m in spec.data["per_layer"]}
    cells = list(spec.workloads)
    for name in list(IDLE) + list(COUNTED):
        m = per_layer[name]
        assert m["moves"] == "profiles_per_s"
        want = ([c for c in cells if c != "nc24_single_ramp"]
                if name == "linalg.lanes_per_factor" else cells)
        assert m["workloads"] == want
