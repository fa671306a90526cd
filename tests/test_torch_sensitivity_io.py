"""``rank_reactions`` and ``save_sensitivities`` / ``load_sensitivities`` of
the port, as ``tests/test_sensitivity.py::test_rank_reactions`` and
``::test_save_load_roundtrip``, and the ``.npz`` format both ways: a file
saved by either package loads in the other, bit for bit.

The ranking runs the default ``rids=None``: every one of the 108
reactions of ``synthetic_pyrolysis_network(6)`` is a tangent lane of one
batched solve; on the CPU the replicated lanes' primal states agree
within the solve's abstol (measured 7.7e-11: the CPU's vectorised kernels
round the last lanes apart), on the card bit for bit.
"""
import numpy as np
import pytest
import torch

from test_torch_sensitivity import make_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def all_reactions():
    from kinetica_tpu_torch.solving.sensitivity import \
        solve_network_sensitivities
    sd, rd, method = make_problem("kinetica_tpu_torch")
    return sd, rd, solve_network_sensitivities(method, sd, rd, device="cpu")


def test_rank_reactions(all_reactions):
    from kinetica_tpu_torch.solving.sensitivity import rank_reactions
    sd, rd, sens = all_reactions
    assert sens.S.shape[2] == rd.nr == 108
    assert sens.stats["lanes"] == rd.nr
    print(f"lane spread {sens.stats['lane_spread']:.2e}")
    assert sens.stats["lane_spread"] <= 1e-10
    ranked = rank_reactions(sens, sd, rd, top_n=5)
    assert len(ranked) == 5
    scores = [s for _, s in ranked]
    assert scores == sorted(scores, reverse=True)
    assert scores[0] > 0
    ranked_sp = rank_reactions(sens, sd, rd, species="C6", top_n=3)
    assert len(ranked_sp) == 3
    _, rd_small, _, _ = __import__(
        "kinetica_tpu_torch.testing.synthetic",
        fromlist=["x"]).synthetic_pyrolysis_network(4)
    with pytest.raises(ValueError, match="reactions"):
        rank_reactions(sens, sd, rd_small)


def test_save_load_roundtrip_both_ways(all_reactions, tmp_path):
    import kinetica_tpu.solving.sensitivity as jsens
    import kinetica_tpu_torch.solving.sensitivity as psens
    from kinetica_tpu.testing.synthetic import \
        synthetic_pyrolysis_network as jax_network
    from kinetica_tpu_torch.testing.synthetic import \
        synthetic_pyrolysis_network
    sd, rd, sens = all_reactions
    # port -> port, with the mismatch check
    path = str(tmp_path / "port")
    psens.save_sensitivities(sens, path)
    back = psens.load_sensitivities(path + ".npz", rd=sens.rd)
    for f in ("t", "u", "S", "rids"):
        np.testing.assert_array_equal(getattr(back, f), getattr(sens, f))
    assert back.rd.nr == sens.rd.nr
    _, rd_small, _, _ = synthetic_pyrolysis_network(4)
    with pytest.raises(ValueError, match="reaction"):
        psens.load_sensitivities(path + ".npz", rd=rd_small)
    # port -> JAX package
    _, jrd, _, _ = jax_network(6)
    jback = jsens.load_sensitivities(path + ".npz", rd=jrd)
    for f in ("t", "u", "S", "rids"):
        np.testing.assert_array_equal(getattr(jback, f), getattr(sens, f))
    # JAX package -> port
    jpath = str(tmp_path / "jax.npz")
    jsens.save_sensitivities(jsens.SensitivitySolution(
        t=sens.t, u=sens.u, S=sens.S[:, :, :3], rids=sens.rids[:3], rd=jrd),
        jpath)
    pback = psens.load_sensitivities(jpath, rd=sens.rd)
    np.testing.assert_array_equal(pback.S, sens.S[:, :, :3])
    np.testing.assert_array_equal(pback.rids, sens.rids[:3])
    with pytest.raises(ValueError, match="reaction"):
        psens.load_sensitivities(jpath, rd=rd_small)
