"""``save_output`` / ``load_output`` (``analysis/io.py``) of the port: the
round trip within the port and the format across packages, both ways.
A discrete-rate ramp solve of the port (condition profile, rate table,
condition traces) is saved by the port and loaded by the JAX package,
re-saved by the JAX package and loaded back by the port; a JAX-package
solve saved by the JAX package loads in the port. Arrays come back bit
for bit, parameters and profiles field for field.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _ramp_out(pkg="kinetica_tpu_torch"):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    sd, rd, Ea, A = mod("testing.synthetic").synthetic_pyrolysis_network(4)
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = mod("calculators.builtin").PrecalculatedArrheniusCalculator(
        Ea, A, k_max=1e12, **kw)
    cs = mod("conditions.condition_set").ConditionSet(
        {"T": mod("conditions.profiles").LinearGradientProfile(
            rate=50.0, X_start=700.0, X_end=750.0)}, ts_update=0.25)
    pars = mod("solving.params").ODESimulationParams(
        tspan=(0.0, 1.0), u0={"C4": 1.0}, solve_chunks=True,
        solve_chunkstep=0.5, save_interval=0.1, low_k_cutoff="none")
    methods = mod("solving.methods")
    return methods.solve_network(methods.VariableODESolve(pars, cs, calc),
                                 sd, rd, **kw)


def _same(a, b):
    for f in ("t", "u"):
        np.testing.assert_array_equal(getattr(a.sol, f), getattr(b.sol, f))
    assert a.sol.retcode == b.sol.retcode
    assert set(a.sol.vcs) == set(b.sol.vcs)
    for k in a.sol.vcs:
        np.testing.assert_array_equal(a.sol.vcs[k], b.sol.vcs[k])
    assert (a.sol_k is None) == (b.sol_k is None)
    if a.sol_k is not None:
        np.testing.assert_array_equal(a.sol_k.t, b.sol_k.t)
        np.testing.assert_array_equal(a.sol_k.u, b.sol_k.u)
    assert a.sd.toInt == b.sd.toInt
    for f in ("nr", "id_reacs", "id_prods", "stoic_reacs", "stoic_prods",
              "rhash"):
        assert getattr(a.rd, f) == getattr(b.rd, f), f
    assert vars(a.pars) == vars(b.pars)
    for pa, pb in zip(a.conditions.profiles, b.conditions.profiles):
        assert type(pa).__name__ == type(pb).__name__
        assert (pa.rate, pa.X_start, pa.X_end) == (pb.rate, pb.X_start,
                                                   pb.X_end)
        np.testing.assert_array_equal(pa.sol.u, pb.sol.u)
    assert a.conditions.ts_update == b.conditions.ts_update


@pytest.fixture(scope="module")
def port_out():
    return _ramp_out()


def test_port_round_trip_and_version(port_out, tmp_path):
    import kinetica_tpu_torch
    from kinetica_tpu_torch.analysis.io import load_output, save_output
    path = str(tmp_path / "out.npz")
    save_output(port_out, path)
    back = load_output(path)
    _same(port_out, back)
    meta = json.loads(bytes(np.load(path)["_meta"]).decode())
    assert meta["KineticaTpuVersion"] == kinetica_tpu_torch.__version__
    assert port_out.sol_k is not None and "T" in port_out.sol.vcs


def test_port_file_loads_in_jax_and_back(port_out, tmp_path):
    import kinetica_tpu.analysis.io as jio
    from kinetica_tpu_torch.analysis.io import load_output, save_output
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_output(port_out, path)
    jback = jio.load_output(path)
    _same(port_out, jback)
    jio.save_output(jback, jpath)
    _same(port_out, load_output(jpath))


def test_jax_solve_loads_in_port(tmp_path):
    import kinetica_tpu.analysis.io as jio
    from kinetica_tpu_torch.analysis.io import load_output
    jout = _ramp_out("kinetica_tpu")
    path = str(tmp_path / "jax.npz")
    jio.save_output(jout, path)
    _same(jout, load_output(path))
