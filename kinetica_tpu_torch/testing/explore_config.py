"""BASELINE config 5 in the port: kinetics-gated iterative exploration.

The setup of ``scripts/bench_explore.py`` (the JAX package's record of
config 5): ``IterativeExplore`` from ``CC`` over the native ``cde_lite``
sampler (``sampling_seed=7``, ``nrxn=4``, ``radius=1``, a minimal
template with two reactions a mechanism), each level gated by a
``batch``-member discrete ``EnsembleProblem`` sweep of
``LinearGradientProfile`` ramps from 600 K at 40-80 K/s over 10 s in 10
chunks, ``seed_conc=0.05``, at most 4 levels. The calculator is
:class:`UniformArrhenius`, the toy on-the-fly calculator of
``examples/iterative_exploration.py``: one shared (Ea, A) for every
reaction.

The JAX package's record (``scripts/explore_results.jsonl``, three runs)
gives the species/reactions by level: :data:`RECORD`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import constants
from ..calculators.base import KineticCalculator
from ..device import DEFAULT_DEVICE, resolve_device

#: (species, reactions) by level in the JAX package's record of config 5
RECORD = ((4, 4), (8, 14), (11, 26), (15, 44))
TF = 10.0


class UniformArrhenius(KineticCalculator):
    """Toy on-the-fly calculator: k = A exp(-Ea / R T) N_A for every
    reaction (``examples/iterative_exploration.py``). A T of shape S gives
    rates of shape S + (nr,) on T's device (the calculator's for a float
    T). ``Ea``, ``A`` and ``k_max = None`` are what
    :func:`~kinetica_tpu_torch.testing.cpu_reference.arrhenius_k_of_t`
    reads, so the scipy-BDF references take it as it is."""
    allows_continuous = True
    k_max = None

    def __init__(self, Ea=8.0e4, A=1.0e-13, device=DEFAULT_DEVICE):
        self.Ea, self.A, self.nr = Ea, A, 0
        self.device = resolve_device(device)

    def setup_network(self, sd, rd):
        self.nr = rd.nr

    def splice(self, rids):
        pass

    def has_conditions(self, symbols):
        return all(s == "T" for s in symbols)

    def __call__(self, T, **_):
        dev = T.device if isinstance(T, torch.Tensor) else self.device
        T = torch.as_tensor(T, dtype=torch.float64, device=dev)
        k = self.A * torch.exp(-self.Ea / (constants.R * T))
        return (k[..., None] * torch.ones(self.nr, dtype=torch.float64,
                                          device=dev) * constants.N_A)


def config5(workdir: str, batch: int = 64, max_levels: int = 4,
            device=DEFAULT_DEVICE):
    """``(exploremethod, solvemethod, conditions_list)`` of config 5 under
    ``workdir`` (the CDE template and the run tree go there); the
    explore method records its per-level ``timings`` and ``gate_log``."""
    from ..conditions.condition_set import ConditionSet
    from ..conditions.profiles import LinearGradientProfile
    from ..exploration import CDE, IterativeExplore
    from ..exploration.cde_lite import get_cde_lite_exec, write_minimal_template
    from ..solving.methods import VariableODESolve
    from ..solving.params import ODESimulationParams

    template = write_minimal_template(os.path.join(workdir, "template"),
                                      nrxn_per_mech=2)
    rates = np.linspace(40.0, 80.0, batch)
    conditions_list = [
        ConditionSet({"T": LinearGradientProfile(
            rate=float(r), X_start=600.0, X_end=600.0 + float(r) * TF)})
        for r in rates]
    pars = ODESimulationParams(tspan=(0.0, TF), u0={"CC": 1.0},
                               solve_chunks=True, solve_chunkstep=TF / 10,
                               low_k_cutoff="none")
    solvemethod = VariableODESolve(pars, conditions_list[0],
                                   UniformArrhenius(device=device))
    exploremethod = IterativeExplore(
        rdir_head=os.path.join(workdir, "crn"),
        reac_smiles=["CC"],
        rxn_convergence_threshold=2,
        seed_convergence_threshold=2,
        seed_conc=0.05,
        max_levels=max_levels,
        solve_conditions_list=conditions_list,
        timings=[], gate_log=[],
        cde=CDE(template_dir=template, cde_exec=get_cde_lite_exec(),
                sampling_seed=7, nrxn=4, radius=1))
    return exploremethod, solvemethod, conditions_list
