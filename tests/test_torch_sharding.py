"""The port's mesh-sharded ensemble over spawned gloo ranks on the CPU.

Ports of ``tests/test_parallel.py``'s sharding cases. Four ranks
(``kinetica_tpu_torch.testing.sharded_ranks``) run, in one spawn:

* a ``(batch=2, model=2)`` mesh on ``synthetic_pyrolysis_network(8)``
  (183 reactions, padded to 184; B = 4 ramps from 500 K at 50-70 K/s, tf
  3 s in 1 s chunks, rate updates every 0.5 s) with the plain dot,
  ``"fused"`` and ``"dd"``, and in continuous mode with ``"fused"``;
* a ``(4,)`` batch mesh on the 6-reaction pyrolysis network (8 ramps from
  300 K at 40-75 K/s, tf 7 s);
* the reference's errors: a model mesh without the constructor mesh, a
  solve() mesh that differs from the constructor's, B % n_batch.

Each sharded solve is held to the port's unsharded solve of the same
inputs in this process (model axis: rtol 1e-4, atol 1e-10 discrete,
rtol 5e-4 continuous, as the reference's tests; batch axis: rtol 1e-6,
atol 1e-12), to the JAX package's unsharded solve to max |du| <= 1e-6
mole fraction (the port's cross-package bound: its f32 Jacobian parts
the packages at ~1e-5 relative), and every rank's solution to every
other's, bit for bit. The block kernels (the fused RHS and the
contraction on a rank's 92 reactions) are held to their plain versions
here and to the reference's shard-local Pallas kernels in interpret mode.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

M22 = ((2, 2), ("batch", "model"))
M41 = ((4, 1), ("batch", "model"))
M4 = ((4,), ("batch",))
NC, B, TF = 8, 4, 3.0
MODEL = dict(network=NC, rates=list(np.linspace(50.0, 70.0, B)), X0=500.0,
             tf=TF, chunk=1.0, ts_update=0.5, u0={f"C{NC}": 1.0},
             mesh=M22, sharding=M22)
CASES = [
    dict(MODEL, name="float64", pars={"rhs_contraction": "float64"}),
    dict(MODEL, name="fused", pars={"rhs_contraction": "fused"},
         check_kernels=True),
    dict(MODEL, name="dd", pars={"rhs_contraction": "dd"}, check_kernels=True),
    dict(MODEL, name="continuous", ts_update=None, rate_mode="continuous",
         pars={"rhs_contraction": "fused"}),
    dict(network="pyrolysis6", name="batch",
         rates=[40.0 + 5 * i for i in range(8)], X0=300.0, tf=7.0, chunk=0.5,
         ts_update=0.5, u0={"C": 1.0}, sharding=M4),
    dict(MODEL, name="no_constructor_mesh", mesh=None, expect_error=True),
    dict(MODEL, name="mesh_differs", sharding=M41, expect_error=True),
    dict(MODEL, name="indivisible", batch=3, expect_error=True),
]
SOLVES = [c for c in CASES if not c.get("expect_error")]
MODEL_TOL = {"float64": 1e-4, "fused": 1e-4, "dd": 1e-4, "continuous": 5e-4}


@pytest.fixture(autouse=True)
def quiet():
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _unsharded(case):
    """The port's unsharded solve of a case's inputs, in this process."""
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.testing.sharded_ranks import ramp_problem
    method, sd, rd, conds = ramp_problem(case, "cpu")
    return EnsembleProblem(method, sd, rd,
                           rate_mode=case.get("rate_mode", "discrete"),
                           device="cpu").solve(conditions_list=conds)


def _jax_problem(case):
    """The JAX package's (method, sd, rd, conditions) of a case."""
    from kinetica_tpu.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu.conditions.condition_set import ConditionSet
    from kinetica_tpu.conditions.profiles import LinearGradientProfile
    from kinetica_tpu.core.network import RxData, SpeciesData
    from kinetica_tpu.solving.methods import VariableODESolve
    from kinetica_tpu.solving.params import ODESimulationParams
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.testing import sharded_ranks
    if case["network"] == "pyrolysis6":
        _, _, Ea, A = sharded_ranks.six_reaction_pyrolysis()
        sd = SpeciesData(["C", "[H]", "[CH3]", "[H][H]", "CC", "C=C"])
        rd = RxData.from_reactions(
            sd,
            reacs=[["C"], ["[CH3]", "[H]"], ["C", "[H]"], ["[CH3]", "[CH3]"],
                   ["CC"], ["CC"]],
            prods=[["[CH3]", "[H]"], ["C"], ["[CH3]", "[H][H]"], ["CC"],
                   ["C=C", "[H][H]"], ["[CH3]", "[CH3]"]])
    else:
        sd, rd, Ea, A = synthetic_pyrolysis_network(case["network"])
    tf, X0 = case["tf"], case["X0"]
    conds = [ConditionSet({"T": LinearGradientProfile(
        rate=float(r), X_start=X0, X_end=X0 + float(r) * tf)},
        ts_update=case.get("ts_update")) for r in case["rates"]]
    pars = ODESimulationParams(tspan=(0.0, tf), u0=dict(case["u0"]),
                               solve_chunks=True, solve_chunkstep=case["chunk"],
                               low_k_cutoff="none")
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)
    return VariableODESolve(pars, conds[0], calc), sd, rd, conds


def _jax_unsharded(case):
    from kinetica_tpu.parallel.batching import EnsembleProblem
    method, sd, rd, conds = _jax_problem(case)
    return EnsembleProblem(method, sd, rd,
                           rate_mode=case.get("rate_mode", "discrete")).solve(
        conditions_list=conds)


@pytest.fixture(scope="module")
def runs():
    """Every rank's results; the port's and the JAX package's unsharded
    solves, computed here while the ranks run."""
    from kinetica_tpu_torch.testing.sharded_ranks import Ranks
    with Ranks(4, {"device": "cpu", "timeout_s": 60, "cases": CASES},
               wait_s=1000) as ranks:
        plain = {c["name"]: _unsharded(c) for c in SOLVES}
        ref = {name: _jax_unsharded(next(c for c in SOLVES
                                         if c["name"] == name))
               for name in ("float64", "continuous", "batch")}
        ranked = ranks.wait()
    return ranked, plain, ref


@pytest.mark.parametrize("name", [c["name"] for c in SOLVES])
def test_every_rank_solves_every_member(runs, name):
    ranked, plain, _ = runs
    for res in ranked:
        r = res[name]
        assert r["retcodes"] == ["Success"] * len(r["retcodes"])
        assert r["u"].shape == plain[name].u.shape
        assert np.all(np.isfinite(r["u"]))


@pytest.mark.parametrize("name", [c["name"] for c in SOLVES])
def test_ranks_return_identical_solutions(runs, name):
    """Every rank returns the whole solution, bit for bit the same; the
    model ranks of a batch block ran identical loops (spread 0)."""
    ranked, _, _ = runs
    for res in ranked[1:]:
        np.testing.assert_array_equal(res[name]["u"], ranked[0][name]["u"])
        np.testing.assert_array_equal(res[name]["n_steps"],
                                      ranked[0][name]["n_steps"])
    assert all(res[name]["rank_spread"] == 0.0 for res in ranked)


@pytest.mark.parametrize("name", list(MODEL_TOL))
def test_model_mesh_matches_unsharded(runs, name):
    ranked, plain, _ = runs
    np.testing.assert_allclose(ranked[0][name]["u"], plain[name].u,
                               rtol=MODEL_TOL[name], atol=1e-10)


def test_batch_mesh_matches_unsharded(runs):
    ranked, plain, _ = runs
    np.testing.assert_allclose(ranked[0]["batch"]["u"], plain["batch"].u,
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,ref_name", [
    ("float64", "float64"), ("fused", "float64"), ("dd", "float64"),
    ("continuous", "continuous"), ("batch", "batch")])
def test_sharded_matches_jax_unsharded(runs, name, ref_name):
    ranked, _, ref = runs
    assert ref[ref_name].success
    assert np.max(np.abs(ranked[0][name]["u"] - np.asarray(ref[ref_name].u))) \
        <= 1e-6


def test_model_ranks_hold_their_reaction_blocks(runs):
    """183 reactions padded to 184 (lcm(1, 2)); rank r = 2 b + m holds
    [92 m, 92 (m + 1)). The model ranks of a batch block make the same
    all_reduce calls; the batch-only mesh makes none."""
    ranked, _, _ = runs
    for rank, res in enumerate(ranked):
        m = rank % 2
        assert (res["fused"]["nr"], res["fused"]["nr_pad"]) == (184, 1)
        assert tuple(res["fused"]["block"]) == (92 * m, 92 * (m + 1))
        assert res["batch"]["all_reduces"] == 0
        assert res["batch"]["block"] is None
    for name in MODEL_TOL:
        for b in (0, 1):
            a0, a1 = (ranked[2 * b + m][name]["all_reduces"] for m in (0, 1))
            assert a0 == a1 > 0


@pytest.mark.parametrize("name", ["fused", "dd"])
def test_block_kernels_match_plain(runs, name):
    ranked, _, _ = runs
    for res in ranked:
        k = res[name]["kernels"]
        assert tuple(k["shape"]) == (2, 92, 25)
        assert k["fused_rhs"] <= 1e-12 and k["dd_contract"] <= 1e-12


def test_constructor_mesh_required(runs):
    ranked, _, _ = runs
    for res in ranked:
        assert "constructor mesh" in res["no_constructor_mesh"]["error"]


def test_solve_mesh_must_match_constructor(runs):
    ranked, _, _ = runs
    for res in ranked:
        assert "differs" in res["mesh_differs"]["error"]


def test_batch_must_split_over_batch_axis(runs):
    ranked, _, _ = runs
    for res in ranked:
        assert "not divisible" in res["indivisible"]["error"]


# ---- without spawned ranks ----

def _pairs(x):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


@pytest.mark.parametrize("lo,hi", [(0, 128), (128, 256)])
def test_block_kernels_match_reference_local_kernels(lo, hi):
    """The port's fused RHS and contraction built on a reaction block
    against the reference's ``make_local_fused_rhs`` / ``make_local_dd_pair``
    (Pallas, interpret mode) on the same block of nc=8 padded to 256:
    |d| <= 1e-12 * sum_j |N_js r_j|."""
    from kinetica_tpu.models.mass_action import build_mass_action as jbuild
    from kinetica_tpu.models.mass_action import pad_reactions as jpad
    from kinetica_tpu.ops import pallas_matmul as pm
    from kinetica_tpu.testing.synthetic import synthetic_pyrolysis_network
    from kinetica_tpu_torch.ops.dd_contract import DDContraction
    from kinetica_tpu_torch.ops.fused_rhs import FusedMassActionRHS
    sd, rd, _, _ = synthetic_pyrolysis_network(NC)
    jnet = jpad(jbuild(rd, sd.n), 256)
    N, slots = np.asarray(jnet.N), np.asarray(jnet.reac_slots)
    rng = np.random.default_rng(lo)
    u = 10.0 ** rng.uniform(-12, 0, (3, sd.n))
    u_aug = np.concatenate([u, np.ones((3, 1))], axis=1)
    k = 10.0 ** rng.uniform(-3, 12, (3, hi - lo))
    r = k * np.prod(u_aug[:, slots[lo:hi]], axis=2)
    bound = np.abs(r) @ np.abs(N[lo:hi]) + 1e-300

    ref_f = pm.FusedMassActionRHS(N, slots, interpret=True, mode="scan")
    local_f = pm.make_local_fused_rhs(ref_f, 2)
    du_ref = np.asarray(jax.vmap(lambda a, b, c, d: local_f(
        a, b, c, d, ref_f._NT[:, lo:hi], ref_f._E[:, lo:hi]))(
            *_pairs(u_aug), *_pairs(k)))
    du = FusedMassActionRHS(N[lo:hi], slots[lo:hi], "cpu")(
        torch.as_tensor(u_aug), torch.as_tensor(k)).numpy()
    assert np.all(np.abs(du - du_ref) <= 1e-12 * bound)

    ref_d = pm.DDContraction(N, interpret=True)
    local_d = pm.make_local_dd_pair(ref_d, 2)
    dd_ref = np.asarray(jax.vmap(lambda a, b: local_d(
        a, b, ref_d._NT[:, lo:hi]))(*_pairs(r)))
    dd = DDContraction(N[lo:hi], "cpu")(torch.as_tensor(r)).numpy()
    assert np.all(np.abs(dd - dd_ref) <= 1e-12 * bound)


@pytest.mark.parametrize("form", ["rhs", "jac_matmul", "jac_segsum",
                                  "autodiff"])
def test_reaction_blocks_sum_to_the_network(form):
    """The shares of a partition into blocks add up to the network's RHS
    and Jacobian (each form the sharded program can run), to 1e-12 of the
    terms' magnitude."""
    from kinetica_tpu_torch.models.mass_action import (build_mass_action,
                                                       pad_reactions)
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, _, _ = synthetic_pyrolysis_network(NC)
    net = pad_reactions(build_mass_action(rd, sd.n, device="cpu"), 184)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(10.0 ** rng.uniform(-12, 0, (3, sd.n)))
    k = torch.as_tensor(10.0 ** rng.uniform(-3, 12, (3, net.nr)))

    def value(n, kk):
        if form == "autodiff":
            return torch.func.vmap(torch.func.jacfwd(n.rhs))(u, kk)
        return getattr(n, form)(u, kk)

    whole = value(net, k)
    parts = sum(value(net.block(lo, lo + 46), k[:, lo:lo + 46])
                for lo in range(0, 184, 46))
    scale = float(whole.abs().max())
    assert float((parts - whole).abs().max()) <= 1e-12 * scale
    with pytest.raises(ValueError, match="outside"):
        net.block(180, 190)


@pytest.mark.parametrize("n_failed,B,multiple,Br", [
    (1, 8, 1, 1), (1, 8, 2, 2), (3, 8, 2, 4), (3, 12, 3, 6), (5, 8, 4, 8),
    (9, 12, 4, 12)])
def test_retry_batch_rounds_up_to_the_batch_axis(n_failed, B, multiple, Br):
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    assert EnsembleProblem._retry_batch_size(n_failed, B, multiple) == Br


def test_make_mesh_needs_a_process_group():
    from kinetica_tpu_torch.parallel.sharding import make_mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group in this process."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    yield
    torch.distributed.destroy_process_group()


def test_mesh_placements_on_one_rank(one_rank):
    """Shapes must use exactly the world's ranks (the reference's check);
    placements cut this rank's block; the host gather joins blocks."""
    from kinetica_tpu_torch.parallel.sharding import (
        batch_sharding, ensemble_shardings, gather_members, make_mesh,
        replicated, shard_ensemble)
    with pytest.raises(ValueError, match="does not use"):
        make_mesh(axis_names=("batch", "model"), shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="every rank"):
        make_mesh(n_devices=2, shape=(2,), device="cpu")
    mesh = make_mesh(axis_names=("batch", "model"), shape=(1, 1),
                     device="cpu")
    assert mesh == make_mesh(axis_names=("batch", "model"), shape=(1, 1),
                             device="cpu")
    assert mesh.devices.size == 1 and mesh.coords == {"batch": 0, "model": 0}
    assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    u0_sh, k_sh = ensemble_shardings(mesh)
    assert u0_sh.spec == ("batch",) and k_sh.spec == ("batch", None, "model")
    x = np.arange(24.0).reshape(4, 3, 2)
    np.testing.assert_array_equal(k_sh.local(x), x)
    assert replicated(mesh).spec == () and batch_sharding(mesh).mesh is mesh
    placed = shard_ensemble(mesh, {"u0": x[:, 0], "k": [x]})
    assert torch.equal(placed["k"][0], torch.as_tensor(x))
    joined, spread = gather_members(mesh, "batch", {"a": x[:, :, 0]},
                                    agree=("a",))
    np.testing.assert_array_equal(joined["a"], x[:, :, 0])
    assert spread == 0.0


def test_sharded_retry_is_global(one_rank):
    """A lane that fails on a (batch, model) mesh is retried with its
    tolerances tightened and merged back, as unsharded (a one-rank mesh,
    so the model program's all_reduce and the ranks' exchange run)."""
    from kinetica_tpu_torch.ops import bdf
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.parallel.sharding import make_mesh
    from kinetica_tpu_torch.testing.sharded_ranks import ramp_problem
    case = next(c for c in SOLVES if c["name"] == "batch")
    method, sd, rd, conds = ramp_problem(dict(case, tf=2.0), "cpu")
    mesh = make_mesh(axis_names=("batch", "model"), shape=(1, 1),
                     device="cpu")
    prob = EnsembleProblem(method, sd, rd, mesh=mesh, device="cpu")
    real, calls = prob._run_batch, []

    def flaky(u0s, payload, stops_rows, abstol, reltol, sharded=False):
        calls.append((u0s.shape[0], float(abstol.min()), sharded))
        st, ys, stats = real(u0s, payload, stops_rows, abstol, reltol,
                             sharded=sharded)
        if len(calls) == 1:
            st = st.copy()
            st[2] = bdf.FAIL_MAX_STEPS
        return st, ys, stats

    prob._run_batch = flaky
    ens = prob.solve(conditions_list=conds[:4], sharding=mesh)
    plain = EnsembleProblem(method, sd, rd, device="cpu").solve(
        conditions_list=conds[:4])
    assert ens.success and ens.stats["attempts"] == 2
    assert ens.stats["retry_batch"] == 1 and ens.stats["rank_spread"] == 0.0
    assert [c[0] for c in calls] == [4, 1] and all(c[2] for c in calls)
    assert calls[1][1] == pytest.approx(method.pars.abstol / 10)
    np.testing.assert_allclose(ens.u[[0, 1, 3]], plain.u[[0, 1, 3]],
                               rtol=1e-4, atol=1e-10)
    assert ens.stats["abstol"][2] == pytest.approx(method.pars.abstol / 10)
