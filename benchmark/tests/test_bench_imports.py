"""What the benchmark loads, checked in fresh processes: no module of it
brings in ``jax`` or the JAX package (top-level names compared whole: the
port, ``kinetica_tpu_torch``, is not ``kinetica_tpu``), and the yardstick
(network, reference, roofline, traffic, check) imports nothing of the
program, nor torch."""
import json
import subprocess
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "kinetica_tpu"}
YARDSTICK = ["benchmark.network", "benchmark.reference", "benchmark.roofline",
             "benchmark.traffic", "benchmark.check"]


def top_level_after(code: str) -> set[str]:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_and_every_reader_load_no_jax():
    code = ("import glob, os\n"
            "import benchmark.run, benchmark.harness, benchmark.control, "
            "benchmark.trace, benchmark.port\n"
            "from benchmark.harness import Spec\n"
            "spec = Spec()\n"
            "for folder in ('entries', 'metrics', 'end_to_end'):\n"
            "    for p in glob.glob(os.path.join('benchmark', folder, '*.py')):\n"
            "        spec.module(folder, os.path.basename(p)[:-3])\n"
            "import kinetica_tpu_torch.parallel.batching, "
            "kinetica_tpu_torch.solving.methods\n")
    loaded = top_level_after(code)
    assert "kinetica_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_a_tiny_run_loads_no_jax(tiny_root):
    code = ("import time, torch\n"
            "from pathlib import Path\n"
            "from benchmark.harness import Spec, run_cell\n"
            f"r = run_cell(Spec(Path({str(tiny_root)!r})), 'tiny_single', 5, "
            "0.01, True, torch.device('cpu'), time.perf_counter(), "
            "log=lambda m: None)\n"
            "assert r['correct']\n"
            "from benchmark.run import forbidden_modules\n"
            "assert forbidden_modules() == []\n")
    assert not top_level_after(code) & FORBIDDEN


@pytest.mark.parametrize("module", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(module):
    loaded = top_level_after(f"import {module}")
    assert not loaded & (FORBIDDEN | {"kinetica_tpu_torch", "torch"})


def test_forbidden_names_are_compared_whole():
    from benchmark.run import forbidden_modules
    assert "kinetica_tpu" not in forbidden_modules() or \
        "kinetica_tpu" in {m.split(".")[0] for m in sys.modules}
    code = ("import sys, types\n"
            "sys.modules['kinetica_tpu_torch_x'] = types.ModuleType('x')\n"
            "sys.modules['jaxfoo'] = types.ModuleType('y')\n"
            "from benchmark.run import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n"
            "sys.modules['kinetica_tpu.ops'] = types.ModuleType('z')\n"
            "assert forbidden_modules() == ['kinetica_tpu']\n")
    top_level_after(code)
