"""The port's package-level API and the solver parameters it decides on.

``kinetica_tpu_torch.<name>`` resolves lazily as ``kinetica_tpu.<name>``
does; the port's table is the JAX package's table, and ``NOT_PORTED``
(the JAX names the port lacks, mirrored in ROADMAP.md) is empty. The parameters the port once accepted and
never read: ``jac_form="segsum"`` is honoured (a segment-sum Jacobian,
equal to the JAX package's ``jac`` to 1e-12), ``progress`` and
``chunks_per_dispatch`` are honoured without changing results or adding
a device-to-host read, and ``lu_precision="full"`` raises where the
factor is an f32 inverse.
"""
import ast
import logging
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_table() -> set:
    """The names of kinetica_tpu's lazy table (a local of __getattr__)."""
    tree = ast.parse(open(os.path.join(ROOT, "kinetica_tpu",
                                       "__init__.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "_API"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no _API table in kinetica_tpu/__init__.py")


def test_every_port_name_resolves():
    import kinetica_tpu_torch
    for name, module in kinetica_tpu_torch._API.items():
        obj = getattr(kinetica_tpu_torch, name)
        assert obj.__module__.startswith("kinetica_tpu_torch"), name
        assert module.startswith("kinetica_tpu_torch")


def test_port_table_is_the_jax_table_less_not_ported():
    import kinetica_tpu
    import kinetica_tpu_torch
    jax_names = _jax_table()
    port = set(kinetica_tpu_torch._API)
    assert port <= jax_names, port - jax_names
    for name in port:
        getattr(kinetica_tpu, name)
    assert jax_names - port == set(kinetica_tpu_torch.NOT_PORTED)
    assert kinetica_tpu_torch.NOT_PORTED == () and port == jax_names
    # each name sits in the port's counterpart of the JAX module
    tree = ast.parse(open(os.path.join(ROOT, "kinetica_tpu",
                                       "__init__.py")).read())
    table = next(node.value for node in ast.walk(tree)
                 if isinstance(node, ast.Assign)
                 and isinstance(node.value, ast.Dict)
                 and any(getattr(t, "id", None) == "_API"
                         for t in node.targets))
    for k, v in zip(table.keys, table.values):
        assert kinetica_tpu_torch._API[k.value] == v.value.replace(
            "kinetica_tpu.", "kinetica_tpu_torch.", 1), k.value
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    missing = [n for n in kinetica_tpu_torch.NOT_PORTED
               if f"`{n}`" not in roadmap]
    assert not missing, missing


@pytest.mark.parametrize("name", ["explore_network", "no_such_name"])
def test_unknown_names_raise(name):
    """A name of the JAX package's table resolves in the port
    (``explore_network``, the last one ported, raised until it was); any
    other name raises."""
    import kinetica_tpu_torch
    if name in _jax_table():
        obj = getattr(kinetica_tpu_torch, name)
        assert obj.__module__.startswith("kinetica_tpu_torch.exploration")
        return
    with pytest.raises(AttributeError, match=name):
        getattr(kinetica_tpu_torch, name)


@pytest.mark.parametrize("nc", [6, 24])
def test_jac_segsum_matches_jax(nc):
    import jax
    import jax.numpy as jnp
    from kinetica_tpu.models.mass_action import build_mass_action as jbuild
    from kinetica_tpu_torch.models.mass_action import build_mass_action
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    sd, rd, _, _ = synthetic_pyrolysis_network(nc)
    rng = np.random.default_rng(nc)
    u = 10.0 ** rng.uniform(-14, 0, (3, sd.n))
    u[rng.random(u.shape) < 0.2] = 0.0
    k = 10.0 ** rng.uniform(-3, 12, (3, rd.nr))
    J0 = np.asarray(jax.vmap(jbuild(rd, sd.n).jac)(jnp.asarray(u),
                                                    jnp.asarray(k)))
    J1 = build_mass_action(rd, sd.n, device="cpu").jac_segsum(
        torch.as_tensor(u), torch.as_tensor(k)).numpy()
    scale = np.abs(J0).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(J1 - J0) <= 1e-12 * scale)


def _solve(**kw):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    ensemble = kw.pop("ensemble", False)
    sd, rd, Ea, A = synthetic_pyrolysis_network(4)
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12, device="cpu")

    def cs(r):
        return ConditionSet({"T": LinearGradientProfile(
            rate=r, X_start=900.0, X_end=900.0 + r)}, ts_update=0.1)
    pars = ODESimulationParams(tspan=(0.0, 1.0), u0={"C4": 1.0},
                               solve_chunks=True, solve_chunkstep=0.25,
                               low_k_cutoff="none", **kw)
    method = VariableODESolve(pars, cs(50.0), calc)
    if ensemble:
        return EnsembleProblem(method, sd, rd, device="cpu").solve(
            conditions_list=[cs(40.0), cs(60.0)])
    return solve_network(method, sd, rd, device="cpu").sol


def test_jac_form_segsum_is_honoured():
    """segsum and matmul J: the same f32 Jacobian to rounding, the same
    solution; the Newton J of the segsum solve comes from jac_segsum."""
    from kinetica_tpu_torch.models.mass_action import MassActionNetwork
    calls = []
    orig = MassActionNetwork.jac_segsum

    def counted(self, u, k):
        calls.append(1)
        return orig(self, u, k)
    MassActionNetwork.jac_segsum = counted
    try:
        seg = _solve(jac_form="segsum")
    finally:
        MassActionNetwork.jac_segsum = orig
    mat = _solve(jac_form="matmul")
    assert calls and seg.success and mat.success
    assert np.max(np.abs(seg.u - mat.u)) <= 1e-7


@pytest.mark.parametrize("ensemble", [False, True])
def test_progress_and_chunk_groups_change_nothing(ensemble, caplog):
    """progress=True logs the chunk groups of chunks_per_dispatch, adds no
    device-to-host read, and every grouping gives the same bits."""
    from kinetica_tpu_torch.ops import host_sync
    host_sync.count = 0
    base = _solve(ensemble=ensemble)
    syncs = host_sync.count
    logging.disable(logging.NOTSET)
    for cpd in (None, 1, 3):
        host_sync.count = 0
        with caplog.at_level(logging.INFO, logger="kinetica_tpu_torch"):
            caplog.clear()
            out = _solve(ensemble=ensemble, progress=True,
                         chunks_per_dispatch=cpd)
        assert host_sync.count == syncs
        np.testing.assert_array_equal(out.u, base.u)
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().strip().startswith(("- Chunkwise ODE",
                                                       "- chunks 1-"))]
        want = {None: 1, 1: 4, 3: 2}[cpd]
        assert len(lines) == want, lines


def test_lu_precision_full_needs_lu():
    with pytest.raises(ValueError, match="lu_precision='full'"):
        _solve(lu_precision="full")
    full = _solve(lu_precision="full", linsolve="lu")
    mixed = _solve(linsolve="lu")
    assert full.success
    np.testing.assert_array_equal(full.u, mixed.u)
