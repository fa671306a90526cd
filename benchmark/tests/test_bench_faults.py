"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference with its state held in float32, at the
configuration's tolerances) reads above the limit a sound run stays
under. The harness's look for a card is skipped: these
drive ``run_cell`` on the CPU at a small size."""
import time

import pytest
import torch

from benchmark.control import readings
from benchmark.harness import Spec, run_cell

from conftest import LIMITS

CPU = torch.device("cpu")


def correct(root, cell):
    return run_cell(Spec(root), cell, 123457, 0.01, False, CPU,
                    time.perf_counter(), log=lambda m: None)["correct"]


def _patch_bdf(monkeypatch, change):
    from kinetica_tpu_torch.ops import bdf
    real = bdf.bdf_solve

    def broken(rhs, jac, y0, *args, **kwargs):
        return change(real(rhs, jac, y0, *args, **kwargs), y0)
    monkeypatch.setattr(bdf, "bdf_solve", broken)


def state_unchanged(res, y0):
    """Every step returns the state it was given."""
    ys = y0.reshape(y0.shape[:1] + (1,) * (res.ys.dim() - 2) + y0.shape[1:])
    return res._replace(ys=ys.expand_as(res.ys).clone(), y_final=y0.clone())


def answer_altered(res, y0):
    """The states are altered where they are produced (1e-5 relative)."""
    return res._replace(ys=res.ys * (1 + 1e-5), y_final=res.y_final)


@pytest.mark.parametrize("cell", ["tiny_b4", "tiny_single"])
@pytest.mark.parametrize("fault", [state_unchanged, answer_altered])
def test_a_broken_solve_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _patch_bdf(monkeypatch, fault)
    assert not correct(tiny_root, cell)


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    """The ensemble solves the first half of the batch and hands its
    answers out again for the other half."""
    import numpy as np
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    real = EnsembleProblem.solve

    def half(self, conditions_list=None, **kw):
        n = len(conditions_list)
        ens = real(self, conditions_list=conditions_list[:n // 2], **kw)
        ens.u = np.concatenate([ens.u, ens.u])[:n]
        ens.retcodes = (list(ens.retcodes) * 2)[:n]
        ens.stats = {k: (np.concatenate([v, v])[:n]
                         if isinstance(v, np.ndarray) and v.shape[:1] ==
                         (n // 2,) else v) for k, v in ens.stats.items()}
        return ens
    monkeypatch.setattr(EnsembleProblem, "solve", half)
    assert not correct(tiny_root, "tiny_b4")


def test_sound_runs_are_correct(tiny_root):
    assert correct(tiny_root, "tiny_b4") and correct(tiny_root, "tiny_single")


@pytest.mark.parametrize("cell", ["tiny_b4", "tiny_single"])
def test_control_reads_above_the_limit(tiny_root, cell):
    rows = readings(Spec(tiny_root), cell, [3, 4], [3, 4], CPU,
                    emit=lambda line: None)
    limit = LIMITS["max_molefrac_err"]["limit"]
    program = [r for r in rows if r["side"] == "program"]
    control = [r for r in rows if r["side"] == "control"]
    assert len(program) == len(control) == 2
    assert all(r["correct"] for r in program), program
    assert not any(r["correct"] for r in control), control
    assert (max(r["max_molefrac_err"] for r in program) < limit
            < min(r["max_molefrac_err"] for r in control))
