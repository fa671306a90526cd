"""The port's exploration drivers over the native ``cde_lite`` sampler.

* ``DirectExplore`` in both packages (Python's ``random`` seeded the same,
  separate run trees): the same species and reaction SMILES, and final
  states within 1e-6; each package's checkpoint loads in the other.
* A two-level ``IterativeExplore`` of config 5 at B=2
  (``testing.explore_config``): every gate member within 1e-6 of a
  segment-wise scipy-BDF reference at the save points, and the seeds
  recomputed from those references equal the driver's.
* An interrupt at the level-2 gate and a resume from the run tree give
  the network and gate of an uninterrupted run.
* The driver refuses to pick seeds from a failed solve (single and
  sweep gates).
"""
import os
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kinetica_tpu_torch.exploration.cde_lite import build_cde_lite  # noqa: E402

pytestmark = pytest.mark.skipif(build_cde_lite() is None,
                                reason="g++ unavailable")


class JaxUniformArrhenius:
    """``testing.explore_config.UniformArrhenius`` for the JAX package."""
    allows_continuous = True
    k_max = None

    def __init__(self, Ea=8.0e4, A=1.0e-13):
        self.Ea, self.A, self.nr = Ea, A, 0

    def setup_network(self, sd, rd):
        self.nr = rd.nr

    def splice(self, rids):
        pass

    def has_conditions(self, symbols):
        return all(s == "T" for s in symbols)

    def __call__(self, T, **_):
        import jax.numpy as jnp
        from kinetica_tpu import constants
        k = self.A * jnp.exp(-self.Ea / (constants.R * jnp.asarray(T)))
        return jnp.asarray(k)[..., None] * jnp.ones((self.nr,)) * constants.N_A


def _direct(pkg, workdir):
    import importlib
    ex = importlib.import_module(f"{pkg}.exploration")
    cl = importlib.import_module(f"{pkg}.exploration.cde_lite")
    cs = importlib.import_module(f"{pkg}.conditions.condition_set")
    meth = importlib.import_module(f"{pkg}.solving.methods")
    par = importlib.import_module(f"{pkg}.solving.params")
    port = pkg.endswith("torch")
    if port:
        from kinetica_tpu_torch.testing.explore_config import UniformArrhenius
        calc = UniformArrhenius(device="cpu")
    else:
        calc = JaxUniformArrhenius()
    template = cl.write_minimal_template(os.path.join(workdir, "template"),
                                         nrxn_per_mech=2)
    pars = par.ODESimulationParams(tspan=(0.0, 1e-3), u0={"CC": 1.0},
                                   solve_chunks=False, save_interval=1e-4,
                                   low_k_cutoff="none")
    method = meth.StaticODESolve(pars, cs.ConditionSet({"T": 900.0}), calc)
    explore = ex.DirectExplore(
        rdir_head=os.path.join(workdir, "crn"), reac_smiles=["CC"],
        cde=ex.CDE(template_dir=template, cde_exec=cl.get_cde_lite_exec(),
                   sampling_seed=7, nrxn=4, radius=1),
        rxn_convergence_threshold=2, maxiters=40)
    random.seed(2024)
    kw = {"device": "cpu"} if port else {}
    return ex.explore_network(explore, method,
                              savedir=os.path.join(workdir, "out"), **kw)


def _rxn_smiles(sd, rd):
    from kinetica_tpu_torch.core.network import format_rxn
    return [format_rxn(sd, rd, i) for i in range(rd.nr)]


def test_direct_explore_matches_jax(tmp_path):
    from kinetica_tpu.analysis.io import load_output as load0
    from kinetica_tpu_torch.analysis.io import load_output as load1
    res0 = _direct("kinetica_tpu", str(tmp_path / "jax"))
    res1 = _direct("kinetica_tpu_torch", str(tmp_path / "port"))
    assert res1.sol.success and res0.sol.success
    assert res1.sd.toInt == res0.sd.toInt and res1.rd.nr == res0.rd.nr >= 2
    assert _rxn_smiles(res1.sd, res1.rd) == _rxn_smiles(res0.sd, res0.rd)
    assert res1.rd.rhash == res0.rd.rhash
    assert res1.rd.mapped_rxns == res0.rd.mapped_rxns
    u0, u1 = np.asarray(res0.sol.u), np.asarray(res1.sol.u)
    assert u1.shape == u0.shape
    assert np.max(np.abs(u1[-1] - u0[-1])) <= 1e-6
    # each package's checkpoint loads in the other
    name = "direct_network_final.npz"
    for path, load in ((tmp_path / "port" / "out" / name, load0),
                       (tmp_path / "jax" / "out" / name, load1),
                       (tmp_path / "port" / "out" / name, load1)):
        out = load(str(path))
        assert out.sd.toInt == res1.sd.toInt and out.rd.nr == res1.rd.nr
        np.testing.assert_allclose(np.asarray(out.sol.u)[-1],
                                   u1[-1] if "port" in str(path) else u0[-1],
                                   rtol=0, atol=0)


def _config5(workdir, max_levels=2):
    from kinetica_tpu_torch.testing.explore_config import config5
    return config5(str(workdir), batch=2, max_levels=max_levels, device="cpu")


def _scipy_gate(entry, method, conds):
    """Each member's segment-wise scipy-BDF trajectory at the gate's save
    times, and the seeds that pick."""
    from kinetica_tpu_torch.solving.solve_utils import make_u0
    from kinetica_tpu_torch.testing.cpu_reference import (
        scipy_bdf_discrete_trajectory)
    sd, rd, sol = entry["sd"], entry["rd"], entry["sol"]
    pars = method.pars
    calc = method.calculator
    calc.setup_network(sd, rd)
    refs = np.stack([scipy_bdf_discrete_trajectory(
        sd, rd, calc, cs.get_profile("T"), sol.t, make_u0(sd, pars),
        pars.reltol, pars.abstol, cs.get_tstops()) for cs in conds])
    max_concs = refs.reshape(-1, sd.n).max(axis=0)
    seeds = [sd.toStr[i] for i in range(sd.n) if max_concs[i] >= 0.05]
    return refs, seeds, max_concs


def test_iterative_config5_gates_match_scipy(tmp_path):
    from kinetica_tpu.analysis.io import load_output as load0
    from kinetica_tpu_torch.analysis.io import load_output as load1
    from kinetica_tpu_torch.exploration import explore_network
    from kinetica_tpu_torch.testing.explore_config import RECORD
    em, sm, conds = _config5(tmp_path)
    random.seed(0)
    res = explore_network(em, sm, savedir=str(tmp_path / "out"), device="cpu")
    assert [(t["n_species"], t["n_reactions"]) for t in em.timings] == list(
        RECORD[:2])
    assert res.sd.n == RECORD[1][0] and res.rd.nr == RECORD[1][1]
    for entry, t in zip(em.gate_log, em.timings):
        sol = entry["sol"]
        assert sol.success and sol.u.shape[0] == 2
        assert t["n_steps_max"] == int(np.max(sol.stats["n_steps"])) > 0
        assert t["host_syncs"] > 0
        refs, seeds, max_concs = _scipy_gate(entry, sm, conds)
        err = np.max(np.abs(sol.u - refs))
        assert err <= 1e-6, (entry["level"], err)
        assert seeds == entry["next_seeds"]
        # no species within the solve's error of the threshold
        assert np.min(np.abs(max_concs - 0.05)) > 1e-4
        # the level's checkpoint loads in both packages
        path = str(tmp_path / "out" / f"level_network_1-{entry['level']}.npz")
        for load in (load0, load1):
            out = load(path)
            assert out.sd.toInt == entry["sd"].toInt
            np.testing.assert_array_equal(np.asarray(out.sol.u), sol.u[0])


def test_interrupt_and_resume(tmp_path, monkeypatch):
    """A crash at the level-2 gate, then a resume from the run tree: the
    network and gate of an uninterrupted run."""
    from kinetica_tpu_torch.exploration import explore_network
    from kinetica_tpu_torch.parallel import batching
    em, sm, _ = _config5(tmp_path / "whole")
    random.seed(0)
    whole = explore_network(em, sm, device="cpu")

    real = batching.EnsembleProblem.solve
    calls = []

    def crash_at_level_2(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("simulated crash at the level-2 gate")
        return real(self, *a, **kw)
    monkeypatch.setattr(batching.EnsembleProblem, "solve", crash_at_level_2)
    em1, sm1, _ = _config5(tmp_path / "resumed")
    random.seed(0)
    with pytest.raises(KeyboardInterrupt):
        explore_network(em1, sm1, device="cpu")
    assert [t["level"] for t in em1.timings] == [1]
    monkeypatch.undo()

    em2, sm2, _ = _config5(tmp_path / "resumed")
    resumed = explore_network(em2, sm2, device="cpu")
    assert [t["level"] for t in em2.timings] == [2]
    assert sorted(resumed.sd.toInt) == sorted(whole.sd.toInt)
    assert sorted(resumed.rd.rhash) == sorted(whole.rd.rhash)
    # the gate's maxima by species agree (the resumed import may order
    # the species differently)
    def maxima(entry):
        u = entry["sol"].u
        m = u.reshape(-1, u.shape[-1]).max(axis=0)
        return {entry["sd"].toStr[i]: m[i] for i in range(entry["sd"].n)}
    a, b = maxima(em.gate_log[-1]), maxima(em2.gate_log[-1])
    assert a.keys() == b.keys()
    assert max(abs(a[k] - b[k]) for k in a) <= 1e-6
    assert sorted(em2.gate_log[-1]["next_seeds"]) == sorted(
        em.gate_log[-1]["next_seeds"])


@pytest.mark.parametrize("gate", ["single", "sweep"])
def test_refuses_to_gate_on_a_failed_solve(tmp_path, monkeypatch, gate):
    import kinetica_tpu_torch.exploration.methods as methods
    from kinetica_tpu_torch.exploration import explore_network
    from kinetica_tpu_torch.parallel import batching
    em, sm, _ = _config5(tmp_path, max_levels=1)
    if gate == "single":
        em.solve_conditions_list = None
        real = methods.solve_network

        def failing(*a, **kw):
            res = real(*a, **kw)
            res.sol.retcode = "MaxIters"
            return res
        monkeypatch.setattr(methods, "solve_network", failing)
    else:
        real = batching.EnsembleProblem.solve

        def failing(self, *a, **kw):
            ens = real(self, *a, **kw)
            ens.retcodes[-1] = "MaxIters"
            return ens
        monkeypatch.setattr(batching.EnsembleProblem, "solve", failing)
    random.seed(0)
    with pytest.raises(RuntimeError, match="refusing to select"):
        explore_network(em, sm, savedir=str(tmp_path / "out"), device="cpu")
    assert em.timings == [] and em.gate_log == []
