"""The BDF step's tail (``kinetica_tpu_torch.ops.bdf._step_tail``) and its
CUDA-graph cache, on the CPU.

- ``graph_refusal``: the graph engages only for CUDA tensors without a
  forward-mode tangent and without grad under grad mode;
- ``tail_key``: every Python value the tail reads is in the key, the
  solve's tensors are not, read from the keys that real calls make;
- the extracted tail, called eagerly, solves the JAX reference cases of
  ``test_torch_bdf.py`` (unchunked, and two chunks with a stop) within
  their tolerances;
- the graph's plumbing (static state, a step's values copied in, a
  solve's tensors bound, results cloned out, the LRU cache bounded by
  count and by bytes), forced on the CPU by a ``graph_refusal`` that
  refuses nothing and a capture that keeps the tail's function in place
  of a CUDA graph: bit-equal to the eager path, one capture a key across
  solves and across ``solve_network``'s chunk calls, results that a later
  solve leaves as they were.

The same on the card, with graphs replayed: ``test_torch_bdf_graph_card.py``.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from test_torch_bdf import BASE, RATES, _compare, _torch_linear

torch.set_num_threads(1)

F64 = torch.float64
STOPS = np.array([[np.inf], [0.3]])


@pytest.fixture(autouse=True)
def accelerator_algorithm(monkeypatch):
    monkeypatch.setenv("KINETICA_REFINE", "unroll:2")
    monkeypatch.setenv("KINETICA_NS_RESIDUAL", "f64dot")


@pytest.fixture
def bdf():
    from kinetica_tpu_torch.ops import bdf
    bdf._tail_graphs.clear()
    yield bdf
    bdf._tail_graphs.clear()


def _keep_function(graph):
    """A capture on the CPU: the tail's function stands in for the
    graph's replay."""
    graph.run = graph._tail()


@pytest.fixture
def forced(bdf, monkeypatch):
    """The graph path on the CPU: nothing refused, and each capture keeps
    the tail's function to run in place of a replay."""
    monkeypatch.setattr(bdf, "graph_refusal", lambda tensors: None)
    monkeypatch.setattr(bdf._TailGraph, "_capture", _keep_function)
    return bdf


def _prep(t_stage, t_start, a):
    off, rate = a
    return rate * (1.0 + t_stage + off)


def solve(bdf, case, y0=1.0, rates=RATES, **kw):
    """One of the two reference cases of ``test_torch_bdf.py``."""
    rhs, jac = _torch_linear()
    y0 = torch.full((len(rates), 3), y0, dtype=F64)
    args = torch.as_tensor(rates)
    common = dict(rtol=1e-8, atol=1e-10, linsolve="inv_gated",
                  lu_drift_tol=0.3)
    common.update(kw)
    if case == "unchunked":
        return bdf.bdf_solve(rhs, jac, y0, 0.0, 1.0, np.array([0.5, 1.0]),
                             args=args, **common)
    return bdf.bdf_solve(rhs, jac, y0, 0.0, 0.5, np.array([0.25, 0.5]),
                         prepare=_prep, args=args, chunks=2,
                         chunk_offsets=np.array([0.0, 0.5]), stops=STOPS,
                         **common)


def _assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is not None:
            assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's vmapped solves of the two cases."""
    from kinetica_tpu.ops import bdf as jbdf
    base = jnp.asarray(BASE)

    def unchunked(a):
        return jbdf.bdf_solve(lambda t, y, a: (a * base) @ y,
                              lambda t, y, a: a * base, jnp.ones(3), 0.0, 1.0,
                              jnp.asarray([0.5, 1.0]), rtol=1e-8, atol=1e-10,
                              linsolve="inv_gated", lu_drift_tol=0.3, args=a)

    def chunked(a):
        return jbdf.bdf_solve(lambda t, y, p: (p * base) @ y,
                              lambda t, y, p: p * base, jnp.ones(3), 0.0, 0.5,
                              jnp.asarray([0.25, 0.5]), rtol=1e-8, atol=1e-10,
                              linsolve="inv_gated", lu_drift_tol=0.3,
                              prepare=_prep, args=a, chunks=2,
                              chunk_offsets=jnp.asarray([0.0, 0.5]),
                              stops=jnp.asarray(STOPS))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KINETICA_REFINE", "unroll:2")
        mp.setenv("KINETICA_NS_RESIDUAL", "f64dot")
        return {name: jax.vmap(fn)(jnp.asarray(RATES))
                for name, fn in (("unchunked", unchunked),
                                 ("chunked", chunked))}


# ---- when the graph engages -------------------------------------------

def test_refused_off_the_card(bdf):
    x = torch.ones(4, dtype=F64)
    assert bdf.graph_refusal([x, x.long()]) == "not on a CUDA device"


def test_refused_for_a_forward_mode_tangent(bdf):
    x = torch.ones(4, dtype=F64)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x, torch.ones_like(x))
        assert bdf.graph_refusal([x, dual]) == "a forward-mode tangent"


def test_refused_for_grad_under_grad_mode(bdf):
    x = torch.ones(4, dtype=F64)
    w = torch.ones(4, dtype=F64, requires_grad=True)
    assert bdf.graph_refusal([x, w]) == "an input requires grad"
    with torch.no_grad():
        # no record to cut: refused only for the device
        assert bdf.graph_refusal([x, w]) == "not on a CUDA device"


def test_tangent_solves_run_eagerly(bdf):
    """A dual ``args`` reaches the initial state, so the solve takes the
    eager path (no replay) and its tangent survives."""
    rhs, jac = _torch_linear()
    with forward_ad.dual_level():
        a = forward_ad.make_dual(torch.as_tensor(RATES[:4]),
                                 torch.ones(4, dtype=F64))
        res = bdf.bdf_solve(rhs, jac, torch.ones(4, 3, dtype=F64), 0.0, 0.5,
                            [0.5], linsolve="inv_gated", args=a)
        assert forward_ad.unpack_dual(res.ys).tangent is not None
    assert not bdf._tail_graphs


# ---- the key ------------------------------------------------------------

@pytest.fixture
def keys(bdf, monkeypatch):
    """The keys real calls make, each solve then run eagerly."""
    got = []
    monkeypatch.setattr(bdf, "graph_refusal", lambda tensors: None)
    monkeypatch.setattr(bdf, "_tail_graph",
                        lambda key, nbytes: got.append(key))
    return got


@pytest.mark.parametrize("case", ["unchunked", "chunked"])
def test_key_ignores_the_solves_tensors(bdf, keys, case):
    solve(bdf, case, max_steps=40)
    solve(bdf, case, y0=2.0, rates=RATES[::-1] * 1.5, rtol=1e-7, atol=1e-9,
          max_steps=40)
    assert len(keys) == 2 and keys[0] == keys[1]


@pytest.mark.parametrize("change", [
    dict(tf=0.75), dict(max_steps=30), dict(nonnegative=True),
    dict(nonnegative_project=True), dict(chunked=False)])
def test_key_holds_every_python_value(bdf, keys, change):
    rhs, jac = _torch_linear()
    y0 = torch.ones(4, 3, dtype=F64)
    args = torch.as_tensor(RATES[:4])

    def call(tf=0.5, max_steps=40, nonnegative=False,
             nonnegative_project=False, chunked=True):
        kw = (dict(prepare=_prep, chunks=2, chunk_offsets=[0.0, tf])
              if chunked else {})
        bdf.bdf_solve(rhs, jac, y0, 0.0, tf, [tf], args=args,
                      max_steps=max_steps, nonnegative=nonnegative,
                      nonnegative_project=nonnegative_project,
                      linsolve="inv_gated", **kw)

    call()
    call(**change)
    assert len(keys) == 2 and keys[0] != keys[1]


# ---- the tail, eager and from the cache ---------------------------------

@pytest.mark.parametrize("case", ["unchunked", "chunked"])
def test_eager_tail_matches_the_jax_reference(bdf, jax_reference, case):
    res = solve(bdf, case)
    assert not bdf._tail_graphs
    ys = res.ys
    assert ys.shape == ((16, 2, 3) if case == "unchunked" else (16, 2, 2, 3))
    ref = jax_reference[case]
    _compare(ref, res, np.asarray(ref.ys), ys)


@pytest.mark.parametrize("case", ["unchunked", "chunked"])
def test_cached_tail_is_bit_equal_to_the_eager_one(bdf, monkeypatch, case):
    monkeypatch.setattr(bdf, "graph_refusal", lambda tensors: "eager")
    eager = solve(bdf, case)
    monkeypatch.setattr(bdf, "graph_refusal", lambda tensors: None)
    monkeypatch.setattr(bdf._TailGraph, "_capture", _keep_function)
    r0, c0 = bdf.tail_replays, bdf.tail_captures
    cached = solve(bdf, case)
    _assert_same(eager, cached)
    assert bdf.tail_captures - c0 == 1
    assert bdf.tail_replays - r0 == int(cached.n_steps.max())


def test_one_capture_serves_solves_and_results_stay(forced):
    bdf = forced
    first = solve(bdf, "chunked")
    kept = [None if x is None else x.clone() for x in first]
    c0 = bdf.tail_captures
    second = solve(bdf, "chunked", y0=2.0, rates=RATES * 1.5, rtol=1e-7)
    assert bdf.tail_captures == c0 and len(bdf._tail_graphs) == 1
    assert not torch.equal(first.ys, second.ys)
    for name, x, y in zip(first._fields, first, kept):
        if x is not None:
            assert torch.equal(x, y), name
    graph = next(iter(bdf._tail_graphs.values()))
    assert all(first.ys.data_ptr() != v.data_ptr()
               for v in graph.state.values())


def test_the_cache_keeps_the_newest_keys(forced):
    bdf = forced
    for steps in range(bdf.MAX_TAIL_GRAPHS + 2):
        solve(bdf, "unchunked", max_steps=40 + steps)
    assert len(bdf._tail_graphs) == bdf.MAX_TAIL_GRAPHS
    assert [k[9] for k in bdf._tail_graphs] == [
        40 + s for s in range(2, bdf.MAX_TAIL_GRAPHS + 2)]


@pytest.mark.parametrize("room", [0, 1.5])
def test_the_cache_keeps_its_bytes(forced, monkeypatch, room):
    """Bounded by its graphs' static state too: room for ``room`` graphs
    of this solve keeps the newest alone (0: even one too large)."""
    bdf = forced
    solve(bdf, "chunked", max_steps=40)
    nbytes = next(iter(bdf._tail_graphs.values())).nbytes
    assert nbytes > 0
    monkeypatch.setattr(bdf, "MAX_TAIL_BYTES", int(room * nbytes))
    for steps in (41, 42):
        solve(bdf, "chunked", max_steps=steps)
    assert [k[9] for k in bdf._tail_graphs] == [42]


def test_a_nested_solve_runs_eagerly(forced):
    """A solve started inside another's callback with the same key finds
    the graph bound and runs eagerly; both are as they would be alone."""
    bdf = forced
    alone = solve(bdf, "chunked")
    inner = []

    def on_chunk(nc):
        if not inner:
            inner.append(solve(bdf, "chunked"))

    outer = solve(bdf, "chunked", on_chunk=on_chunk)
    _assert_same(alone, outer)
    _assert_same(alone, inner[0])


def test_solve_network_captures_once_for_its_chunks(forced, monkeypatch):
    """``solve_network``'s chunkwise dispatch: every chunk call (same
    window, saves and Python values) replays the one capture."""
    bdf = forced
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    logging.disable(logging.INFO)
    try:
        sd, rd, Ea, A = synthetic_pyrolysis_network(6)
        calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e10,
                                                device="cpu")
        cs = ConditionSet({"T": LinearGradientProfile(
            rate=50.0, X_start=800.0, X_end=825.0)})
        pars = ODESimulationParams(
            tspan=(0.0, 0.5), u0={"C6": 1.0}, solve_chunks=True,
            solve_chunkstep=0.125, low_k_cutoff="none", abstol=1e-6,
            reltol=1e-3, linsolve="inv_fused", rhs_contraction="dd")
        method = VariableODESolve(pars, cs, calc)
        r0, c0 = bdf.tail_replays, bdf.tail_captures
        graphed = solve_network(method, sd, rd, device="cpu")
        assert graphed.sol.stats["n_chunks"] == 4
        assert bdf.tail_captures - c0 == 1
        assert bdf.tail_replays - r0 == graphed.sol.stats["n_steps"]
        bdf._tail_graphs.clear()
        monkeypatch.setattr(bdf, "graph_refusal", lambda tensors: "eager")
        eager = solve_network(method, sd, rd, device="cpu")
    finally:
        logging.disable(logging.NOTSET)
    np.testing.assert_array_equal(graphed.sol.u, eager.sol.u)
