"""The BDF step's tail replayed from CUDA graphs on the card
(``kinetica_tpu_torch.ops.bdf._TailGraph``).

Marked ``card``: each test skips without a CUDA device. On the card, run
this file alone (the tests' ``conftest.py`` loads JAX, which the card's
machine does not have)::

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_bdf_graph_card.py

Problems are those of the benchmark's cells: the 24-carbon network (73
species) under 40-60 K/s ramps from 500 K, 28 chunks of 0.5 s, rtol 1e-8,
atol 1e-10; a 64-lane async-chunk ensemble ("inv_gated") and a one-lane
chunkwise ``solve_network`` ("inv_fused", DD contraction).

- replayed tails are bit-equal to the eager ones over 50 steps (B=64
  chunked, B=1 unchunked), and the capture raises no error;
- a result outlives the next solve with the same key unchanged, through
  ``bdf_solve`` and through ``EnsembleProblem.solve``;
- one capture serves the 28 ``bdf_solve`` calls of a ``solve_network``,
  whose solution equals the eager one bit for bit;
- a new key's capture adds no cuBLAS workspace (every capture on a
  device shares one stream);
- with two or more cards, a solve on a card that is not the current one
  (a 3-species linear system, "lu") captures and replays on its own
  card, bit-equal to its eager run.
"""
import logging

import numpy as np
import pytest
import torch

NC, T0, TF, CHUNK = 24, 500.0, 14.0, 0.5
F64 = torch.float64


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def bdf(card):
    from kinetica_tpu_torch.ops import bdf
    bdf._tail_graphs.clear()
    yield bdf
    bdf._tail_graphs.clear()


def _problem(device, rates, tf=TF, **settings):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, Ea, A = synthetic_pyrolysis_network(NC)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device=device)
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=T0, X_end=T0 + float(r) * tf)})
        for r in rates]
    pars = ODESimulationParams(
        tspan=(0.0, tf), u0={f"C{NC}": 1.0}, solve_chunks=True,
        solve_chunkstep=CHUNK, low_k_cutoff="none", abstol=1e-10,
        reltol=1e-8, jac_policy="lazy", lu_drift_tol=0.3, **settings)
    return sd, rd, VariableODESolve(pars, conds[0], calc), conds


def _ensemble(device, batch=64, tf=TF):
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    sd, rd, method, conds = _problem(device, np.linspace(40.0, 60.0, batch),
                                     tf=tf, linsolve="auto",
                                     rhs_contraction="auto")
    return EnsembleProblem(method, sd, rd, rate_mode="continuous",
                           device=device), conds


def _single(device):
    sd, rd, method, _ = _problem(device, [47.0], linsolve="inv_fused",
                                 rhs_contraction="dd")
    return method, sd, rd


class _Grabbed(Exception):
    pass


def _first_call(bdf, monkeypatch, run):
    """The arguments of the first ``bdf_solve`` call that ``run`` makes."""
    got = []

    def grab(*args, **kwargs):
        got.append((args, kwargs))
        raise _Grabbed

    with monkeypatch.context() as mp:
        mp.setattr(bdf, "bdf_solve", grab)
        with pytest.raises(_Grabbed):
            run()
    return got[0]


def _solve_both(bdf, monkeypatch, call, **over):
    """``call``'s solve eager, then from a fresh capture: both results,
    and the replays and captures the second made."""
    args, kwargs = call
    kwargs = dict(kwargs, **over)
    with monkeypatch.context() as mp:
        mp.setattr(bdf, "graph_refusal", lambda tensors: "eager")
        eager = bdf.bdf_solve(*args, **kwargs)
    r0, c0 = bdf.tail_replays, bdf.tail_captures
    graphed = bdf.bdf_solve(*args, **kwargs)
    torch.cuda.synchronize()
    return eager, graphed, bdf.tail_replays - r0, bdf.tail_captures - c0


def _assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is not None:
            assert torch.equal(x, y), name


@pytest.mark.card
def test_b64_chunked_tail_replays_bit_equal(bdf, card, monkeypatch):
    ens, conds = _ensemble(card)
    call = _first_call(bdf, monkeypatch,
                       lambda: ens.solve(conditions_list=conds))
    assert call[1]["chunks"] == 28
    eager, graphed, replays, captures = _solve_both(bdf, monkeypatch, call,
                                                    max_steps=50)
    _assert_same(eager, graphed)
    assert int(graphed.n_steps.max()) == 50
    assert (replays, captures) == (50, 1)
    graph = next(iter(bdf._tail_graphs.values()))
    assert isinstance(graph.graph, torch.cuda.CUDAGraph)


@pytest.mark.card
def test_b1_unchunked_tail_replays_bit_equal(bdf, card, monkeypatch):
    from kinetica_tpu_torch.solving.methods import solve_network
    method, sd, rd = _single(card)
    call = _first_call(bdf, monkeypatch,
                       lambda: solve_network(method, sd, rd, device=card))
    assert call[1].get("chunks") is None and call[0][2].shape[0] == 1
    eager, graphed, replays, captures = _solve_both(bdf, monkeypatch, call,
                                                    max_steps=50)
    _assert_same(eager, graphed)
    assert int(graphed.n_steps.max()) == 50
    assert (replays, captures) == (50, 1)


@pytest.mark.card
def test_capture_under_sync_checks(bdf, card, monkeypatch):
    """The capture (a synchronising call inside it would end it with an
    error) and the replays after it, with the device's sync debugging on:
    a step's copies and replay make no synchronising call (the loop's own
    reads are the counted ones, outside the graph)."""
    ens, conds = _ensemble(card, batch=8)
    args, kwargs = _first_call(bdf, monkeypatch,
                               lambda: ens.solve(conditions_list=conds))
    state = {}
    real = bdf._TailGraph.replay

    def replay(self, st):
        # the capture itself synchronises the device as it begins
        torch.cuda.set_sync_debug_mode(
            "default" if self.run is None else "error")
        try:
            real(self, st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        state["n"] = state.get("n", 0) + 1

    monkeypatch.setattr(bdf._TailGraph, "replay", replay)
    c0 = bdf.tail_captures
    bdf.bdf_solve(*args, **dict(kwargs, max_steps=5))
    torch.cuda.synchronize()
    assert state["n"] == 5 and bdf.tail_captures - c0 == 1


@pytest.mark.card
def test_results_outlive_the_next_solve(bdf, card, monkeypatch):
    ens, conds = _ensemble(card, tf=2.0)
    args, kwargs = _first_call(bdf, monkeypatch,
                               lambda: ens.solve(conditions_list=conds))
    first = bdf.bdf_solve(*args, **kwargs)
    kept = [None if x is None else x.clone() for x in first]
    c0 = bdf.tail_captures
    y0 = args[2] * 0.5
    second = bdf.bdf_solve(*args[:2], y0, *args[3:], **kwargs)
    torch.cuda.synchronize()
    assert bdf.tail_captures == c0
    assert not torch.equal(first.ys, second.ys)
    for name, x, y in zip(first._fields, first, kept):
        if x is not None:
            assert torch.equal(x, y), name
    # and through the ensemble's own entry
    u1 = ens.solve(conditions_list=conds).u
    u1_kept = np.array(u1, copy=True)
    ens.solve(conditions_list=conds[::-1])
    np.testing.assert_array_equal(u1, u1_kept)


@pytest.mark.card
def test_solve_network_captures_once(bdf, card, monkeypatch):
    from kinetica_tpu_torch.solving.methods import solve_network
    method, sd, rd = _single(card)
    r0, c0 = bdf.tail_replays, bdf.tail_captures
    graphed = solve_network(method, sd, rd, device=card)
    assert graphed.sol.stats["n_chunks"] == 28
    assert bdf.tail_captures - c0 == 1
    assert bdf.tail_replays - r0 == graphed.sol.stats["n_steps"]
    with monkeypatch.context() as mp:
        mp.setattr(bdf, "graph_refusal", lambda tensors: "eager")
        eager = solve_network(method, sd, rd, device=card)
    np.testing.assert_array_equal(graphed.sol.u, eager.sol.u)


@pytest.mark.card
def test_keys_share_one_capture_stream(bdf, card, monkeypatch):
    """A second key's capture adds its small static state and no cuBLAS
    workspace (tens of MiB for each stream cuBLAS has run on)."""
    ens, conds = _ensemble(card, batch=8, tf=2.0)
    args, kwargs = _first_call(bdf, monkeypatch,
                               lambda: ens.solve(conditions_list=conds))
    bdf.bdf_solve(*args, **dict(kwargs, max_steps=5))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    bdf.bdf_solve(*args, **dict(kwargs, max_steps=6))
    torch.cuda.synchronize()
    assert len(bdf._tail_graphs) == 2 and len(bdf._capture_streams) == 1
    assert torch.cuda.memory_allocated(card) - before < 4 << 20


def _prep(t_stage, t_start, a):
    off, rate = a
    return rate * (1.0 + t_stage + off)


@pytest.mark.card
@pytest.mark.parametrize("chunked", [False, True])
def test_a_solve_off_the_current_card(bdf, card, monkeypatch, chunked):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    base = torch.tensor([[-1.0, 0.2, 0.0], [0.3, -2.0, 0.1],
                         [0.0, 0.5, -0.5]], dtype=F64, device=other)

    def rhs(t, y, a):
        return ((a[:, None, None] * base) @ y[..., None])[..., 0]

    def jac(t, y, a):
        return a[:, None, None] * base

    y0 = torch.ones(16, 3, dtype=F64, device=other)
    kwargs = dict(args=torch.linspace(1.0, 40.0, 16, dtype=F64,
                                      device=other),
                  rtol=1e-8, atol=1e-10, linsolve="lu")
    if chunked:
        kwargs.update(prepare=_prep, chunks=2,
                      chunk_offsets=np.array([0.0, 0.5]),
                      stops=np.array([[np.inf], [0.3]]))
    call = ((rhs, jac, y0, 0.0, 0.5, np.array([0.25, 0.5])), kwargs)
    eager, graphed, replays, captures = _solve_both(bdf, monkeypatch, call)
    _assert_same(eager, graphed)
    assert graphed.ys.device == other and bool((graphed.status == 1).all())
    assert (replays, captures) == (int(graphed.n_steps.max()), 1)
    assert torch.cuda.current_device() == 0
