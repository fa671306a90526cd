"""The tutorials of ``docs/tutorials`` as executed documentation on the port.

The Python blocks of each tutorial run in order in one namespace seeded
with the small objects the prose assumes (network, calculator,
conditions, a solved result), in the working directory the caller
chooses: the port's counterparts of ``tests/test_docs_tutorials.py``'s
namespaces, built from the port's objects with every entry point's
default device (the card). The only change to a block is the package
name (:func:`port_block`).

Three blocks plot with matplotlib (:data:`MATPLOTLIB_BLOCKS`), and one
block reads the result of one of them (:data:`NEEDS`); a run on a machine
without matplotlib passes ``skip=without_matplotlib()`` and lists them.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "tutorials")

#: (tutorial, block index) of the blocks that import matplotlib
MATPLOTLIB_BLOCKS = frozenset({("results-analysis.md", 0),
                               ("results-analysis.md", 2),
                               ("sensitivity-analysis.md", 2)})


#: blocks that read a name only an earlier block makes -> that block
NEEDS = {("sensitivity-analysis.md", 3): ("sensitivity-analysis.md", 2)}


def without_matplotlib() -> dict:
    """The blocks a machine without matplotlib cannot run, each with why."""
    out = {b: "imports matplotlib" for b in MATPLOTLIB_BLOCKS}
    for block, need in NEEDS.items():
        if need in out:
            out[block] = f"reads what block {need[1]} makes"
    return out


def extract_blocks(path: str) -> list[str]:
    with open(path) as fh:
        return re.findall(r"```python\n(.*?)```", fh.read(), re.S)


def port_block(block: str) -> str:
    """The block with the JAX package's name replaced by the port's."""
    return re.sub(r"\bkinetica_tpu\b", "kinetica_tpu_torch", block)


def small_crn():
    from ..calculators.builtin import PrecalculatedArrheniusCalculator
    from ..core.network import RxData, SpeciesData
    sd = SpeciesData(["C", "[H]", "[CH3]", "[H][H]", "CC", "C=C"])
    rd = RxData.from_reactions(
        sd,
        reacs=[["C"], ["[CH3]", "[H]"], ["C", "[H]"], ["[CH3]", "[CH3]"],
               ["CC"], ["CC"]],
        prods=[["[CH3]", "[H]"], ["C"], ["[CH3]", "[H][H]"], ["CC"],
               ["C=C", "[H][H]"], ["[CH3]", "[CH3]"]],
        dH=[4.5, -4.5, 0.1, -3.8, 1.5, 3.8])
    Ea = np.array([3.6e5, 0.0, 4.0e4, 0.0, 3.2e5, 3.5e5])
    A = np.array([1e-8, 1e-12, 1e-13, 1e-12, 1e-7, 1e-8])
    calc = PrecalculatedArrheniusCalculator(Ea, A, k_max=1e12)
    return sd, rd, calc


def solved_namespace(tf=2.0, ts_update=0.5, chunkstep=0.5, u0_spec="CC"):
    """sd/rd/calc/cs/conditions/pars/method/res/t: what the prose assumes."""
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import LinearGradientProfile
    from ..solving.methods import VariableODESolve, solve_network
    from ..solving.params import ODESimulationParams

    sd, rd, calc = small_crn()
    cs = ConditionSet(
        {"T": LinearGradientProfile(rate=300.0, X_start=1100.0,
                                    X_end=1100.0 + 300.0 * tf)},
        ts_update=ts_update)
    pars = ODESimulationParams(tspan=(0.0, tf), u0={u0_spec: 1.0},
                               solve_chunks=True, solve_chunkstep=chunkstep,
                               low_k_cutoff="none")
    method = VariableODESolve(pars, cs, calc)
    res = solve_network(method, sd, rd)
    return dict(np=np, sd=sd, rd=rd, calc=calc, cs=cs, conditions=cs,
                tf=tf, pars=pars, method=method, res=res, t=tf / 2,
                VariableODESolve=VariableODESolve,
                solve_network=solve_network,
                ODESimulationParams=ODESimulationParams,
                ConditionSet=ConditionSet)


def ns_arbitrary_conditions():
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import DoubleRampGradientProfile
    return dict(ConditionSet=ConditionSet,
                DoubleRampGradientProfile=DoubleRampGradientProfile)


def ns_filtering():
    from ..solving.filters import RxFilter
    ns = solved_namespace()
    ns["RxFilter"] = RxFilter
    return ns


def ns_iterative_exploration():
    from ..calculators.builtin import DummyKineticCalculator
    from ..conditions.condition_set import ConditionSet
    from ..device import DEFAULT_DEVICE, resolve_device
    from ..exploration.cde import CDE
    from ..exploration.cde_lite import get_cde_lite_exec, write_minimal_template
    from ..exploration.methods import IterativeExplore, explore_network
    from ..solving.methods import StaticODESolve
    from ..solving.params import ODESimulationParams
    write_minimal_template("template")
    pars = ODESimulationParams(tspan=(0.0, 1.0), u0={"CC": 1.0},
                               solve_chunks=False, save_interval=0.1,
                               low_k_cutoff="none", allow_short_u0=True)

    class UniformCalc(DummyKineticCalculator):
        def __init__(self):
            self.device = resolve_device(DEFAULT_DEVICE)

        allows_continuous = True

        def setup_network(self, sd, rd):
            self.nr = rd.nr

        def splice(self, rids):
            pass

        def has_conditions(self, symbols):
            return True

        def __call__(self, **_):
            return torch.full((self.nr,), 0.5, dtype=torch.float64,
                              device=self.device)

    solve_method = StaticODESolve(pars, ConditionSet({"T": 500.0}),
                                  UniformCalc())
    return dict(CDE=CDE, get_cde_lite_exec=get_cde_lite_exec,
                IterativeExplore=IterativeExplore,
                explore_network=explore_network, solve_method=solve_method)


def ns_kinetic_calculators():
    from ..calculators.base import KineticCalculator
    from ..calculators.kpm import DESCRIPTOR_DIM
    ns = solved_namespace()
    ns["KineticCalculator"] = KineticCalculator
    rng = np.random.default_rng(0)
    arrs = {}
    for m in range(2):
        arrs[f"W{m}_0"] = rng.normal(size=(DESCRIPTOR_DIM, 8))
        arrs[f"b{m}_0"] = rng.normal(size=8)
        arrs[f"W{m}_1"] = rng.normal(size=(8, 1))
        arrs[f"b{m}_1"] = rng.normal(size=1)
    np.savez("kpm_model.npz", **arrs)
    return ns


def ns_logging():
    return solved_namespace()


def ns_ode_solution():
    ns = solved_namespace(tf=0.02, ts_update=5e-3, chunkstep=1e-3)
    ns["t"] = 0.01
    return ns


def ns_results_analysis():
    return solved_namespace()


def ns_saving_loading():
    from ..analysis.io import load_output, save_output
    ns = solved_namespace()
    ns.update(save_output=save_output, load_output=load_output)
    return ns


def ns_sensitivity():
    from ..core.network import print_rxn
    ns = solved_namespace()
    ns["print_rxn"] = print_rxn
    return ns


def ns_full_product():
    from ..exploration.cde_lite import write_minimal_template
    write_minimal_template("template")
    return {}


NAMESPACES = {
    "arbitrary-conditions.md": ns_arbitrary_conditions,
    "full-product.md": ns_full_product,
    "filtering-crns.md": ns_filtering,
    "iterative-exploration.md": ns_iterative_exploration,
    "kinetic-calculators.md": ns_kinetic_calculators,
    "logging.md": ns_logging,
    "ode-solution.md": ns_ode_solution,
    "results-analysis.md": ns_results_analysis,
    "saving-loading.md": ns_saving_loading,
    "sensitivity-analysis.md": ns_sensitivity,
}


def run_blocks(name: str, ns: dict, blocks, skip=frozenset(), keep=()):
    """Run ``blocks`` of tutorial ``name`` in order in ``ns``; returns one
    ``(block index, seconds, {name: value})`` for each block run, with the
    values of the names in ``keep`` after it, and ``(block index, None,
    {})`` for each block in ``skip``. A block that raises fails the run
    with its name."""
    ns.setdefault("np", np)
    log = []
    for i, block in enumerate(blocks):
        if (name, i) in skip:
            log.append((i, None, {}))
            continue
        t0 = time.perf_counter()
        exec(compile(block, f"{name}[block {i}]", "exec"), ns)
        log.append((i, time.perf_counter() - t0,
                    {k: ns[k] for k in keep if k in ns}))
    return log


def run_tutorial(name: str, skip=frozenset(), keep=()) -> tuple[dict, list]:
    """Run tutorial ``name``'s blocks on the port in the current directory:
    ``(namespace, log)`` (:func:`run_blocks`)."""
    ns = NAMESPACES[name]()
    blocks = [port_block(b) for b in extract_blocks(os.path.join(DOCS, name))]
    return ns, run_blocks(name, ns, blocks, skip, keep)
