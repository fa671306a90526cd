"""Kernel 5 (grid probe): the start-up check, with the device part mocked.

The probe adds an (8, 128) block of ones into a zeroed output from a grid
of 2 blocks and expects 2.0 everywhere, as the reference's
``fused_grid_supported``. On this CPU-only machine the kernel cannot run,
so the probe's launch (``grid_probe._run``) and the card's name are
replaced by stand-ins; the plain version is checked for the value itself.
"""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def probe(monkeypatch):
    from kinetica_tpu_torch.ops import grid_probe
    monkeypatch.setattr(grid_probe, "passed", False)
    calls = []

    def fake_run(device, value=2.0):
        calls.append(device)
        return torch.full((grid_probe.ROWS, grid_probe.COLS), value)

    monkeypatch.setattr(grid_probe, "_run", fake_run)
    monkeypatch.setattr(grid_probe, "_card_name", lambda device: "Test Card X")
    return grid_probe, calls


def test_plain_version_gives_the_block_count():
    from kinetica_tpu_torch.ops.grid_probe import BLOCKS, grid_probe
    out = grid_probe(torch.ones(8, 128))
    assert torch.equal(out, torch.full((8, 128), float(BLOCKS)))


def test_runs_once_per_process_on_cuda(probe):
    grid_probe, calls = probe
    grid_probe.ensure_grid_supported("cuda")
    grid_probe.ensure_grid_supported("cuda:0")
    grid_probe.ensure_grid_supported(torch.device("cuda"))
    assert len(calls) == 1 and grid_probe.passed


def test_never_runs_on_cpu(probe):
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    grid_probe, calls = probe
    grid_probe.ensure_grid_supported("cpu")
    N = torch.eye(3, dtype=torch.float64)
    FusedMassActionRHS(N, torch.zeros(3, 2, dtype=torch.long), "cpu")
    DDContraction(N, "cpu")
    assert calls == [] and not grid_probe.passed


def test_failed_probe_raises_naming_the_card(probe, monkeypatch):
    grid_probe, _ = probe
    monkeypatch.setattr(grid_probe, "_run", lambda device: torch.ones(8, 128))
    with pytest.raises(RuntimeError, match="Test Card X"):
        grid_probe.ensure_grid_supported("cuda")
    assert not grid_probe.passed


@pytest.mark.parametrize("which", ["fused_rhs", "dd_contract"])
def test_constructors_run_the_probe_on_cuda(probe, monkeypatch, which):
    """Building a kernel's network for a CUDA device runs the probe first,
    before anything is allocated there: a failed probe stops it."""
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    grid_probe, _ = probe
    monkeypatch.setattr(grid_probe, "_run", lambda device: torch.ones(8, 128))
    N = torch.eye(3, dtype=torch.float64)
    build = {"fused_rhs": lambda: FusedMassActionRHS(
        N, torch.zeros(3, 2, dtype=torch.long), "cuda"),
        "dd_contract": lambda: DDContraction(N, "cuda")}[which]
    with pytest.raises(RuntimeError, match="grid probe failed on Test Card X"):
        build()
