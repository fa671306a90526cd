"""Executable documentation on the port: every Python block of
``docs/tutorials/*.md`` runs against ``kinetica_tpu_torch`` on the CPU,
with only the package name changed, and the objects it makes are held to
the JAX package's.

This holds the port's API, not its choice of device: the blocks call
the entry points with their defaults (the card), and a fixture maps the
port's ``resolve_device("cuda")`` to the CPU for this file alone.
``tests/test_torch_device_defaults.py`` holds the defaults.

The namespaces are ``kinetica_tpu_torch.testing.tutorials``'s, the port's
counterparts of ``tests/test_docs_tutorials.py``'s. The JAX side runs the
same blocks in that file's namespaces; where it is too slow for tier 1
(``logging``, ``sensitivity-analysis``, ``ode-solution`` and
``filtering-crns`` are in ``tests/slow_tests.txt``), the port is held to
the records of a JAX run pinned in
``kinetica_tpu_torch/testing/tutorial_records.json``
(``python tests/test_torch_docs_tutorials.py`` writes them anew).
Tolerances:

* trajectories (``res.sol.u``, ``ss.u``, ``back.sol.u``, ``res_d.sol.u``):
  within 1e-7 of the largest entry plus 10 x abstol, the solves'
  tolerances (reltol 1e-8, abstol 1e-10) at the port's f32 Newton factor;
* the explored network and ``flux.top(3)``'s reactions: equal; the
  extents within 1e-6 of the largest;
* DRG (``filtering-crns``): the port's kept reactions contain the JAX
  package's and meet the tutorial's tol (1e-4). The graph's CC -> CH3
  edge is set by samples where CC is below abstol (3e-15 in one package,
  0 in the other), so it is 0.19 in one and 0.51 in the other, on either
  side of eps = 0.3 (ROADMAP, traps);
* KPM rates: 1e-12 relative;
* ``sens.S``: within 1e-4 of the JAX package's central differences of
  ``u`` in ln k (step 0.01; their resolution is ~reltol / 0.01 = 1e-6),
  where the states are O(1): the tangents are not error-controlled, and
  the port's are 5.0e-5 off at most on a CPU. The JAX package's own
  tangents are 2.6 off those differences on this ramp (ROADMAP, traps),
  so the port is not held to them;
* Morris elementary effects: the design is equal for the same seed; an
  effect whose objective change exceeds 10 x abstol in either package
  must agree within 1e-6 of max|ee|, an exact zero (a reaction that
  never reaches the objective) must stay zero, and the rest lie below
  that threshold in both (unresolved data: ROADMAP, traps). So the
  Morris survivors that the Sobol block takes are the same set, in an
  order the unresolved effects decide.
"""
import importlib
import json
import os
import pkgutil
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(ROOT, "kinetica_tpu_torch", "testing",
                       "tutorial_records.json")
# tutorials whose JAX run is slow: held to the pinned records
PINNED = ("filtering-crns.md", "logging.md", "ode-solution.md",
          "sensitivity-analysis.md")
ABSTOL = 1e-10
KEEP = ("res", "res_d", "sens", "ss", "eqmap", "back", "red", "flux", "k",
        "cs", "sres", "explore", "timings")


@pytest.fixture
def port_on_cpu(monkeypatch):
    """The port's ``resolve_device`` maps ``cuda`` to the CPU, in every
    module of the port (each binds it by name) and for modules imported
    later."""
    import kinetica_tpu_torch
    from kinetica_tpu_torch import device as dev_mod
    orig = dev_mod.resolve_device

    def resolve(device):
        device = torch.device(device)
        return torch.device("cpu") if device.type == "cuda" else orig(device)

    for info in pkgutil.walk_packages(kinetica_tpu_torch.__path__,
                                      "kinetica_tpu_torch."):
        if ".examples." in info.name or ".scripts." in info.name:
            continue
        importlib.import_module(info.name)
    for name, mod in list(sys.modules.items()):
        if (name.startswith("kinetica_tpu_torch")
                and getattr(mod, "resolve_device", None) is orig):
            monkeypatch.setattr(mod, "resolve_device", resolve)


def _u(res):
    return np.asarray(res.sol.u)


def extract(name, ns, log):
    """The objects each tutorial's blocks make that both packages compare."""
    after = {i: snap for i, _, snap in log}
    if name == "arbitrary-conditions.md":
        return dict(tstops=np.asarray(ns["cs"].get_tstops()),
                    tf=np.asarray([ns["tf"]]))
    if name == "filtering-crns.md":
        return dict(res_u=_u(after[0]["res"]),
                    keep_rids=list(ns["red"].reduction.keep_rids),
                    red_error=float(ns["red"].error))
    if name == "iterative-exploration.md":
        from_pkg = type(ns["res"]).__module__.split(".")[0]
        fmt = importlib.import_module(f"{from_pkg}.core.network").format_rxn
        res = ns["res"]
        return dict(species=[res.sd.toStr[i] for i in range(res.sd.n)],
                    reactions=[fmt(res.sd, res.rd, i)
                               for i in range(res.rd.nr)],
                    res_u=_u(res))
    if name == "kinetic-calculators.md":
        return dict(k=np.asarray(ns["k"]))
    if name == "logging.md":
        return dict(res_u=_u(ns["res"]))
    if name == "ode-solution.md":
        return dict(res_u=_u(after[0]["res"]), ss_u=np.asarray(ns["ss"].u),
                    eqmap_u=np.asarray(ns["eqmap"].u))
    if name == "results-analysis.md":
        top = ns["flux"].top(3)
        return dict(res_d_u=_u(ns["res_d"]),
                    top_rids=[int(r) for r, _ in top],
                    top_extents=np.asarray([float(e) for _, e in top]))
    if name == "saving-loading.md":
        return dict(back_u=_u(ns["back"]))
    if name == "sensitivity-analysis.md":
        return dict(sens0_S=np.asarray(after[0]["sens"].S),
                    sens0_u=np.asarray(after[0]["sens"].u),
                    sens1_S=np.asarray(after[1]["sens"].S),
                    sens1_rids=[int(r) for r in after[1]["sens"].rids],
                    morris_ee=np.asarray(after[2]["res"].ee),
                    sobol_rids=[int(r) for r in ns["sres"].rids])
    return {}


def _jax_run(name, tmp_path):
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_docs_tutorials as jt
    from kinetica_tpu_torch.testing.tutorials import (DOCS, extract_blocks,
                                                      run_blocks)
    cwd = os.getcwd()
    os.makedirs(tmp_path / "jax", exist_ok=True)
    os.chdir(tmp_path / "jax")
    try:
        ns = jt.NAMESPACES[name]()
        log = run_blocks(name, ns, extract_blocks(os.path.join(DOCS, name)),
                         keep=KEEP)
        return extract(name, ns, log), ns
    finally:
        os.chdir(cwd)


def _close_traj(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max() + 10 * ABSTOL


def _morris_check(ee_port, ee_jax, delta=2.0 / 3.0):
    """Resolved elementary effects agree, exact zeros stay zero, the rest
    lie below the resolution threshold in both packages."""
    ee_port, ee_jax = np.asarray(ee_port), np.asarray(ee_jax)
    floor = 10 * ABSTOL / delta           # |ee| of a 10 x abstol change
    resolved = (np.abs(ee_port) > floor) | (np.abs(ee_jax) > floor)
    scale = np.abs(ee_jax).max()
    assert np.all(np.abs(ee_port - ee_jax)[resolved] <= 1e-6 * scale)
    np.testing.assert_array_equal(ee_port[ee_jax == 0.0], 0.0)
    assert np.all(np.abs(ee_port[~resolved]) <= floor)
    assert np.all(np.abs(ee_jax[~resolved]) <= floor)


def compare(name, port, ref):
    for key in ("res_u", "ss_u", "eqmap_u", "res_d_u", "back_u", "sens0_u"):
        if key in ref:
            _close_traj(port[key], ref[key])
    for key in ("tstops", "tf"):
        if key in ref:
            np.testing.assert_array_equal(port[key], ref[key])
    for key in ("species", "reactions", "top_rids", "sens1_rids"):
        if key in ref:
            assert list(port[key]) == list(ref[key]), key
    if "keep_rids" in ref:
        assert set(ref["keep_rids"]) <= set(port["keep_rids"])
        assert port["red_error"] <= 1e-4
    if "sobol_rids" in ref:
        assert sorted(port["sobol_rids"]) == sorted(ref["sobol_rids"])
    if "top_extents" in ref:
        top = np.asarray(ref["top_extents"])
        assert np.abs(port["top_extents"] - top).max() <= 1e-6 * top.max()
    if "k" in ref:
        np.testing.assert_allclose(port["k"], ref["k"], rtol=1e-12, atol=0)
    if "fd_S" in ref:
        fd = np.asarray(ref["fd_S"])
        assert np.abs(port["sens0_S"] - fd).max() <= 1e-4
        cols = np.asarray(port["sens1_rids"])
        assert np.abs(port["sens1_S"] - fd[..., cols]).max() <= 1e-4
    if "morris_ee" in ref:
        _morris_check(port["morris_ee"], ref["morris_ee"])


def _load_records():
    with open(RECORDS) as fh:
        return json.load(fh)


NAMES = sorted(("arbitrary-conditions.md", "filtering-crns.md",
                "full-product.md", "iterative-exploration.md",
                "kinetic-calculators.md", "logging.md", "ode-solution.md",
                "results-analysis.md", "saving-loading.md",
                "sensitivity-analysis.md"))


@pytest.mark.parametrize("name", NAMES)
def test_tutorial_blocks_on_the_port(name, tmp_path, monkeypatch,
                                     port_on_cpu):
    from kinetica_tpu_torch.testing.tutorials import NAMESPACES, run_tutorial
    assert set(NAMESPACES) == set(NAMES)
    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    ns, log = run_tutorial(name, keep=KEEP)
    assert all(sec is not None for _, sec, _ in log)
    port = extract(name, ns, log)
    if name in PINNED:
        ref = _load_records()[name]
    else:
        ref, _ = _jax_run(name, tmp_path)
    compare(name, port, ref)


def test_every_tutorial_is_covered():
    from kinetica_tpu_torch.testing.tutorials import (DOCS, MATPLOTLIB_BLOCKS,
                                                      NAMESPACES,
                                                      extract_blocks)
    files = {f for f in os.listdir(DOCS) if f.endswith(".md")}
    assert files == set(NAMESPACES) == set(NAMES)
    assert set(_load_records()) == set(PINNED)
    for name, i in MATPLOTLIB_BLOCKS:
        assert "matplotlib" in extract_blocks(os.path.join(DOCS, name))[i] \
            or "plotting" in extract_blocks(os.path.join(DOCS, name))[i]
    plotting = {(n, i) for n in NAMESPACES
                for i, b in enumerate(extract_blocks(os.path.join(DOCS, n)))
                if "plotting" in b or "matplotlib" in b}
    assert plotting == set(MATPLOTLIB_BLOCKS)
    # the block that reads the Morris result of a plotting block
    from kinetica_tpu_torch.testing.tutorials import NEEDS, without_matplotlib
    name, i = next(iter(NEEDS))
    assert "res.ranking()" in extract_blocks(os.path.join(DOCS, name))[i]
    assert set(without_matplotlib()) == set(MATPLOTLIB_BLOCKS) | set(NEEDS)


def _jax_central_differences(ns, eps=0.01):
    """d u / d ln k_j at the save points of the JAX package's solve of the
    sensitivity tutorial's ramp, by central differences of k_j scaled
    after the calculator (the rate constants the solve integrates)."""
    import jax.numpy as jnp
    from kinetica_tpu.solving.methods import VariableODESolve, solve_network

    calc0 = ns["calc"]

    class Scaled:
        allows_continuous = calc0.allows_continuous

        def __init__(self, factors):
            self.factors = jnp.asarray(factors)

        def setup_network(self, sd, rd):
            calc0.setup_network(sd, rd)

        def has_conditions(self, symbols):
            return calc0.has_conditions(symbols)

        def __call__(self, **kw):
            return calc0(**kw) * self.factors

    nr = ns["rd"].nr
    cols = []
    for j in range(nr):
        us = []
        for sgn in (1.0, -1.0):
            f = np.ones(nr)
            f[j] = np.exp(sgn * eps)
            out = solve_network(VariableODESolve(ns["pars"], ns["cs"],
                                                 Scaled(f)), ns["sd"], ns["rd"])
            us.append(np.asarray(out.sol.u))
        cols.append((us[0] - us[1]) / (2 * eps))
    return np.stack(cols, axis=-1)


def jax_tutorial_records(workdir):
    """The JAX package's objects of the pinned tutorials (``PINNED``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pathlib
    out = {}
    for name in PINNED:
        rec, ns = _jax_run(name, pathlib.Path(workdir) / name)
        if name == "sensitivity-analysis.md":
            import test_docs_tutorials as jt
            rec["fd_S"] = _jax_central_differences(jt.ns_sensitivity())
            rec["jax_sens0_S"] = rec.pop("sens0_S")
            rec.pop("sens1_S")
        out[name] = {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                         else v) for k, v in rec.items()}
    return out


if __name__ == "__main__":
    import tempfile
    sys.path.insert(0, ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        records = jax_tutorial_records(tmp)
    with open(RECORDS, "w") as fh:
        json.dump(records, fh, indent=0)
    print(f"wrote {RECORDS}")
