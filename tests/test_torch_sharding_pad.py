"""Reaction-axis padding of the sharded ensemble against the JAX package's
own sharded solve.

``nr_multiple=4`` on the 6-reaction pyrolysis network of
``tests/test_parallel.py`` (4 ramps from 300 K at 40-70 K/s, tf 7 s in
0.5 s chunks) over a ``(batch=2, model=4)`` mesh: eight spawned gloo ranks
(``kinetica_tpu_torch.testing.sharded_ranks``), each model rank holding
two of the 8 padded reactions, in both rate modes. The JAX package solves
the same inputs over ``make_mesh(8, ("batch", "model"), (2, 4))`` on
``tests/conftest.py``'s 8 virtual CPU devices. Without a per-shard
``DD_CHUNK`` factor (the reference pads its Pallas kernels' shards with
it; the port's kernels take any count) both packages pad 6 reactions to
8. The port's sharded solve is held to the JAX package's to max |du| <=
1e-6 mole fraction, to its own unsharded solve at the model axis's
tolerances (rtol 1e-4 discrete, 5e-4 continuous; atol 1e-10), and its
ranks to each other bit for bit.
"""
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

M24 = ((2, 4), ("batch", "model"))
BASE = dict(network="pyrolysis6", rates=[40.0, 50.0, 60.0, 70.0], X0=300.0,
            tf=7.0, chunk=0.5, u0={"C": 1.0}, mesh=M24, sharding=M24,
            nr_multiple=4)
CASES = [dict(BASE, name="discrete", ts_update=0.5),
         dict(BASE, name="continuous", ts_update=None, rate_mode="continuous")]
RTOL = {"discrete": 1e-4, "continuous": 5e-4}


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _port_unsharded(case):
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.testing.sharded_ranks import ramp_problem
    method, sd, rd, conds = ramp_problem(case, "cpu")
    prob = EnsembleProblem(method, sd, rd, rate_mode=case.get("rate_mode",
                                                              "discrete"),
                           nr_multiple=case["nr_multiple"], device="cpu")
    return prob, prob.solve(conditions_list=conds)


def _jax_sharded(case):
    from kinetica_tpu.parallel.batching import EnsembleProblem
    from kinetica_tpu.parallel.sharding import make_mesh
    from test_torch_sharding import _jax_problem
    method, sd, rd, conds = _jax_problem(case)
    mesh = make_mesh(8, axis_names=M24[1], shape=M24[0])
    prob = EnsembleProblem(method, sd, rd, rate_mode=case.get("rate_mode",
                                                              "discrete"),
                           nr_multiple=case["nr_multiple"], mesh=mesh)
    return prob, prob.solve(conditions_list=conds, sharding=mesh)


@pytest.fixture(scope="module")
def runs():
    from kinetica_tpu_torch.testing.sharded_ranks import Ranks
    with Ranks(8, {"device": "cpu", "timeout_s": 60, "cases": CASES},
               wait_s=900) as ranks:
        plain = {c["name"]: _port_unsharded(c) for c in CASES}
        ref = {c["name"]: _jax_sharded(c) for c in CASES}
        ranked = ranks.wait()
    return ranked, plain, ref


@pytest.mark.parametrize("name", list(RTOL))
def test_padded_network_matches_jax(runs, name):
    """Both packages pad 6 reactions to 8; the port's padded unsharded
    problem too."""
    ranked, plain, ref = runs
    jprob, _ = ref[name]
    assert (jprob.net.nr, jprob._nr_pad) == (8, 2)
    assert (plain[name][0].net.nr, plain[name][0]._nr_pad) == (8, 2)
    for rank, res in enumerate(ranked):
        assert (res[name]["nr"], res[name]["nr_pad"]) == (8, 2)
        m = rank % 4
        assert tuple(res[name]["block"]) == (2 * m, 2 * m + 2)


@pytest.mark.parametrize("name", list(RTOL))
def test_sharded_matches_jax_sharded(runs, name):
    ranked, _, ref = runs
    _, jens = ref[name]
    assert jens.success and ranked[0][name]["retcodes"] == ["Success"] * 4
    assert np.max(np.abs(ranked[0][name]["u"] - np.asarray(jens.u))) <= 1e-6


@pytest.mark.parametrize("name", list(RTOL))
def test_sharded_matches_unsharded(runs, name):
    ranked, plain, _ = runs
    np.testing.assert_allclose(ranked[0][name]["u"], plain[name][1].u,
                               rtol=RTOL[name], atol=1e-10)


@pytest.mark.parametrize("name", list(RTOL))
def test_ranks_agree(runs, name):
    ranked, _, _ = runs
    for res in ranked:
        np.testing.assert_array_equal(res[name]["u"], ranked[0][name]["u"])
        assert res[name]["rank_spread"] == 0.0
    # the four model ranks of each batch block made the same all_reduces
    for b in (0, 1):
        counts = {ranked[4 * b + m][name]["all_reduces"] for m in range(4)}
        assert len(counts) == 1 and counts.pop() > 0


def test_a_failing_rank_fails_the_run_without_hanging():
    """Rank 1 raises before its first collective; rank 0 blocks in one
    until the group's 5 s timeout. The run raises with rank 1's report
    at once, and leaving it stops rank 0."""
    import time

    from kinetica_tpu_torch.testing.sharded_ranks import Ranks
    case = dict(BASE, name="fails", mesh=None, sharding=((2,), ("batch",)),
                fail_rank=1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        with Ranks(2, {"device": "cpu", "timeout_s": 5, "cases": [case]},
                   wait_s=120) as ranks:
            ranks.wait()
    assert time.monotonic() - t0 < 60
    assert not any(p.is_alive() for p in ranks._procs)
