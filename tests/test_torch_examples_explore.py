"""The port's exploring examples on the CPU against the JAX package's
records of the same examples.

The JAX examples take 20-40 s each on a CPU (the full product at its
test size and the iterative exploration among them), too slow for tier 1
beside the port's runs, so the port is held to the records of a JAX run
pinned in ``kinetica_tpu_torch/testing/example_records.py``
(``python tests/test_torch_examples.py`` prints them anew):

* ``getting_started`` (mock CDE, ``DirectExplore``): the explored species
  and reactions equal, member 0's final state within 1e-8, and
  ``results.npz`` loads back in both packages;
* ``iterative_exploration`` at its published settings: the species and
  reactions by level and the explored network equal, the final state
  within 1e-8;
* ``full_product`` at ``n_sweep=3, max_levels=2, reduce_tol=0.5``: the
  assertions of ``tests/test_full_product.py``, the explored network,
  the observable and the DRGEP kept set equal to the JAX package's, the
  validated error within 1e-6 of its, Morris mu* within 1e-6 of max mu*.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def _network(res):
    from kinetica_tpu_torch.core.network import format_rxn
    sd, rd = res.sd, res.rd
    return ([sd.toStr[i] for i in range(sd.n)],
            [format_rxn(sd, rd, i) for i in range(rd.nr)])


def test_getting_started_matches_jax_record(tmp_path):
    from kinetica_tpu.analysis.io import load_output as jload
    from kinetica_tpu_torch.analysis.io import load_output
    from kinetica_tpu_torch.examples import getting_started
    from kinetica_tpu_torch.testing.example_records import GETTING_STARTED
    out = getting_started.main(workdir=str(tmp_path), device="cpu")
    species, reactions = _network(out.res)
    assert species == GETTING_STARTED["species"]
    assert reactions == GETTING_STARTED["reactions"]
    assert out.res.sol.success
    assert np.abs(out.res.sol.u[-1]
                  - np.asarray(GETTING_STARTED["u_final"])).max() <= 1e-8
    back = load_output(out.results)
    np.testing.assert_array_equal(back.sol.u, out.res.sol.u)
    np.testing.assert_array_equal(np.asarray(jload(out.results).sol.u),
                                  out.res.sol.u)


def test_iterative_exploration_matches_jax_record(tmp_path):
    from kinetica_tpu_torch.examples import iterative_exploration
    from kinetica_tpu_torch.testing.example_records import (
        ITERATIVE_EXPLORATION as REC)
    out = iterative_exploration.main(workdir=str(tmp_path), device="cpu")
    levels = [(t["n_species"], t["n_reactions"]) for t in out.em.timings]
    assert levels == REC["levels"]
    species, reactions = _network(out.res)
    assert species == REC["species"] and reactions == REC["reactions"]
    assert all(e["sol"].success for e in out.em.gate_log)
    assert np.abs(np.asarray(out.res.sol.u)[-1]
                  - np.asarray(REC["u_final"])).max() <= 1e-8


def test_full_product_small_matches_jax_record(tmp_path):
    from kinetica_tpu_torch.examples import full_product
    from kinetica_tpu_torch.testing.example_records import (
        FULL_PRODUCT_SMALL as REC)
    record = {}
    sd, rd, mres, red = full_product.main(
        n_sweep=3, max_levels=2, quiet=True, reduce_tol=0.5,
        workdir=str(tmp_path), device="cpu", record=record)
    # tests/test_full_product.py's assertions
    assert sd.n >= 4 and rd.nr >= 4
    assert mres.mu_star.shape == (rd.nr,)
    assert np.all(np.isfinite(mres.mu_star))
    assert 0 < len(red.reduction.keep_rids) <= rd.nr
    assert red.error <= 0.5
    # and the JAX package's record
    levels = [(t["n_species"], t["n_reactions"]) for t in record["em"].timings]
    assert levels == REC["levels"]
    species, reactions = _network(record["res"])
    assert species == REC["species"] and reactions == REC["reactions"]
    assert record["target"] == REC["target"]
    assert red.reduction.keep_rids == REC["keep_rids"]
    assert abs(red.error - REC["error"]) <= 1e-6
    mu = np.asarray(REC["mu_star"])
    assert np.abs(mres.mu_star - mu).max() <= 1e-6 * mu.max()
    assert record["ens"].success
