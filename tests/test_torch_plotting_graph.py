"""Plots, graph export and BSON decoding of the port against the JAX
package, as ``tests/test_rk45_analysis.py::TestPlotting`` / ``::TestGraph``
and ``tests/test_compat_extras.py::TestBSONCompat::test_roundtrip_simple_doc``:
the same recipes draw the same artists from the port's results (lines,
bars, labels), the DOT text of both packages is equal character for
character, and the decoder reads the same document. Plotting runs on the
host only; the package imports matplotlib inside the plot functions.
"""
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _small_result(pkg="kinetica_tpu_torch"):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    network = mod("core.network")
    sd = network.SpeciesData(["A", "B", "C"])
    rd = network.RxData.from_reactions(sd, [["A"], ["B", "B"]], [["B"], ["C"]],
                                       dH=[1.0, -2.0])
    pars = mod("solving.params").ODESimulationParams(
        tspan=(0.0, 5.0), u0={"A": 1.0}, solve_chunks=False,
        save_interval=0.5, low_k_cutoff="none")
    kw = {"device": "cpu"} if pkg == "kinetica_tpu_torch" else {}
    calc = mod("calculators.builtin").DummyKineticCalculator(
        np.array([1.0, 0.4]), **kw)
    cs = mod("conditions.condition_set").ConditionSet({"T": 300.0})
    methods = mod("solving.methods")
    return methods.solve_network(methods.StaticODESolve(pars, cs, calc),
                                 sd, rd, **kw)


def test_plot_recipes_match_reference():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import kinetica_tpu.analysis.plotting as jplot
    import kinetica_tpu_torch.analysis.plotting as plot
    res = _small_result()
    ax = plot.plot_solution(res, label_above=0.01)
    ax_ref = jplot.plot_solution(res, label_above=0.01)
    assert len(ax.lines) == len(ax_ref.lines) == 3
    for a, b in zip(ax.lines, ax_ref.lines):
        np.testing.assert_array_equal(a.get_ydata(), b.get_ydata())
    ax2 = plot.finalconcplot(res, n_top=3, mode="percent")
    ax2_ref = jplot.finalconcplot(res, n_top=3, mode="percent")
    assert len(ax2.patches) == 3
    assert ([p.get_width() for p in ax2.patches]
            == [p.get_width() for p in ax2_ref.patches])
    with pytest.raises(ValueError):
        plot.finalconcplot(res, mode="bogus")


def test_conditionsplot_variable():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    from kinetica_tpu_torch.analysis.plotting import conditionsplot
    from kinetica_tpu_torch.calculators.builtin import \
        PrecalculatedArrheniusCalculator
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                    solve_network)
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    sd = SpeciesData(["A", "B"])
    rd = RxData.from_reactions(sd, [["A"]], [["B"]])
    cs = ConditionSet({"T": LinearGradientProfile(rate=10.0, X_start=300.0,
                                                  X_end=400.0)})
    pars = ODESimulationParams(tspan=(0.0, 10.0), u0={"A": 1.0},
                               solve_chunks=False, low_k_cutoff="none")
    calc = PrecalculatedArrheniusCalculator(np.array([1e4]),
                                            np.array([1e-22]), device="cpu")
    vres = solve_network(VariableODESolve(pars, cs, calc), sd, rd,
                         device="cpu")
    ax = conditionsplot(vres, "T")
    assert "Temperature" in ax.get_ylabel()
    np.testing.assert_array_equal(ax.lines[0].get_ydata(), vres.sol.vcs["T"])


def test_analysis_plots_smoke():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    from kinetica_tpu_torch.analysis import plotting
    from kinetica_tpu_torch.analysis.screening import morris_screening
    from kinetica_tpu_torch.analysis.sobol import sobol_sensitivity
    from test_torch_screening import chain_network, make_method
    sd, rd, calc = chain_network()
    res = morris_screening(make_method(calc), sd, rd, objective="CCC",
                           n_trajectories=3, seed=4, device="cpu")
    ax = plotting.morrisplot(res, sd, rd)
    assert ax.get_xlabel().startswith("$\\mu") and len(ax.collections) == 1
    sres = sobol_sensitivity(make_method(calc), sd, rd, objective="CCC",
                             n_samples=8, seed=6, device="cpu")
    ax = plotting.sobolplot(sres, sd, rd)
    assert "Sobol index" in ax.get_xlabel()
    assert len(ax.containers) == 2 and len(ax.containers[0]) == rd.nr
    # flux and sensitivity traces
    from kinetica_tpu_torch.solving.methods import solve_network
    from kinetica_tpu_torch.solving.sensitivity import SensitivitySolution
    out = solve_network(make_method(calc), sd, rd, device="cpu")
    ax = plotting.fluxplot(out, calc=calc, top_n=2, attribution="projected")
    assert len(ax.get_lines()) == 2
    S = np.random.default_rng(0).standard_normal(out.sol.u.shape + (3,))
    sens = SensitivitySolution(t=out.sol.t, u=out.sol.u, S=S,
                               rids=np.arange(3), rd=out.rd)
    ax = plotting.sensitivityplot(sens, sd, "CCC", top_n=2)
    assert len(ax.lines) == 3                      # 2 traces + zero line


def test_plotting_module_does_not_import_matplotlib():
    code = ("import sys, kinetica_tpu_torch.analysis.plotting, "
            "kinetica_tpu_torch.analysis.reduction; "
            "sys.exit(int(any(m.startswith('matplotlib') for m in sys.modules)))")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_dot_export_matches_reference(tmp_path):
    from kinetica_tpu.analysis.graph import Graph as JGraph
    from kinetica_tpu_torch.analysis.graph import Graph, savegraph
    from kinetica_tpu_torch.core.network import RxData, SpeciesData
    res = _small_result()
    g = Graph(res.sd, res.rd, use_smiles=True)
    dot = g.to_dot()
    assert dot == JGraph(res.sd, res.rd, use_smiles=True).to_dot()
    assert dot.startswith("digraph G {")
    assert '"A" -> "R₁"' in dot and 'label="2"' in dot and 'level="1"' in dot
    path = savegraph(g, str(tmp_path / "crn.dot"))
    assert open(path).read() == dot
    sd = SpeciesData(["A", "B", "Zombie"])
    rd = RxData.from_reactions(sd, [["A"]], [["B"]])
    assert len(Graph(sd, rd).active_species()) == 2
    assert len(Graph(sd, rd, remove_inactive_species=False)
               .active_species()) == 3


def test_bson_roundtrip_simple_doc():
    from kinetica_tpu.analysis.bson_compat import parse_bson as jparse
    from kinetica_tpu_torch.analysis.bson_compat import parse_bson
    body = b"\x01x\x00" + struct.pack("<d", 1.5)
    doc = struct.pack("<i", 4 + len(body) + 1) + body + b"\x00"
    assert parse_bson(doc) == jparse(doc) == {"x": 1.5}
