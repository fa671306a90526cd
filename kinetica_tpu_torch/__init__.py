"""kinetica_tpu_torch: the PyTorch/CUDA port of kinetica_tpu.

The port runs the JAX package's stiff mass-action solves on one NVIDIA
GPU: host layer copied from the JAX package, solvers written in PyTorch,
and the JAX package's Pallas kernels as five CUDA C++ kernels under
``csrc/`` (the fused mass-action RHS, the DD contraction, the batched
Gauss-Jordan inverse, the fused Newton solve and the grid probe). Paths
it runs: ``solve_network`` (static, continuous and discrete rates,
complete or chunkwise, BDF or RK45, f64 or f32 state), the batched
ensemble (``EnsembleProblem``, ``solve_network_ensemble``; over a process
mesh of ``torch.distributed`` ranks, members split over ``"batch"`` and
reactions over ``"model"``: ``parallel.sharding``), steady states
single and batched with their sensitivities, the adjoint gradient, the
forward sensitivities (tangents through the kernels' forward-mode
rules), the analysis layer (save/load, fluxes, Morris, Sobol,
DRG/DRGEP, graph export, plots), the chemistry layer and the TST,
ASE-NEB and KPM calculators, and CRN exploration (``explore_network``
over the native ``cde_lite`` sampler, each level gated by a kinetic solve
on the device), with host section timers and a ``torch.profiler`` trace
(``utils.profiling``). It never imports jax.

Importing the package sets the float32 matmul precision policy (see
:mod:`kinetica_tpu_torch.precision`): every f32 product the solver makes
is a full-f32 product, as the JAX package's ``Precision.HIGHEST``.
"""
from .precision import set_precision_policy

set_precision_policy()

__version__ = "0.1.0"

# Public API shortcuts, resolved lazily as in kinetica_tpu/__init__.py
_API = {
    "SpeciesData": "kinetica_tpu_torch.core.network",
    "RxData": "kinetica_tpu_torch.core.network",
    "init_network": "kinetica_tpu_torch.core.network",
    "format_rxn": "kinetica_tpu_torch.core.network",
    "print_rxn": "kinetica_tpu_torch.core.network",
    "ConditionSet": "kinetica_tpu_torch.conditions.condition_set",
    "StaticConditionProfile": "kinetica_tpu_torch.conditions.profiles",
    "NullDirectProfile": "kinetica_tpu_torch.conditions.profiles",
    "LinearDirectProfile": "kinetica_tpu_torch.conditions.profiles",
    "SawtoothDirectProfile": "kinetica_tpu_torch.conditions.profiles",
    "NullGradientProfile": "kinetica_tpu_torch.conditions.profiles",
    "LinearGradientProfile": "kinetica_tpu_torch.conditions.profiles",
    "DoubleRampGradientProfile": "kinetica_tpu_torch.conditions.profiles",
    "DummyKineticCalculator": "kinetica_tpu_torch.calculators.builtin",
    "PrecalculatedArrheniusCalculator": "kinetica_tpu_torch.calculators.builtin",
    "PrecalculatedLindemannCalculator": "kinetica_tpu_torch.calculators.builtin",
    "TSTCalculator": "kinetica_tpu_torch.calculators.tst",
    "ASENEBCalculator": "kinetica_tpu_torch.ase.calculator",
    "ODESimulationParams": "kinetica_tpu_torch.solving.params",
    "RxFilter": "kinetica_tpu_torch.solving.filters",
    "StaticODESolve": "kinetica_tpu_torch.solving.methods",
    "VariableODESolve": "kinetica_tpu_torch.solving.methods",
    "solve_network": "kinetica_tpu_torch.solving.methods",
    "CDE": "kinetica_tpu_torch.exploration",
    "DirectExplore": "kinetica_tpu_torch.exploration",
    "IterativeExplore": "kinetica_tpu_torch.exploration",
    "explore_network": "kinetica_tpu_torch.exploration",
    "KPMRun": "kinetica_tpu_torch.calculators.kpm",
    "KPMBasicCalculator": "kinetica_tpu_torch.calculators.kpm",
    "KPMCollisionCalculator": "kinetica_tpu_torch.calculators.kpm",
    "KPMCollisionEntropyCalculator": "kinetica_tpu_torch.calculators.kpm",
    "ODESolveOutput": "kinetica_tpu_torch.analysis.io",
    "save_output": "kinetica_tpu_torch.analysis.io",
    "load_output": "kinetica_tpu_torch.analysis.io",
    "SensitivityProblem": "kinetica_tpu_torch.solving.sensitivity",
    "solve_network_sensitivities": "kinetica_tpu_torch.solving.sensitivity",
    "rank_reactions": "kinetica_tpu_torch.solving.sensitivity",
    "save_sensitivities": "kinetica_tpu_torch.solving.sensitivity",
    "load_sensitivities": "kinetica_tpu_torch.solving.sensitivity",
    "morris_screening": "kinetica_tpu_torch.analysis.screening",
    "MorrisResult": "kinetica_tpu_torch.analysis.screening",
    "sobol_sensitivity": "kinetica_tpu_torch.analysis.sobol",
    "SobolResult": "kinetica_tpu_torch.analysis.sobol",
    "saltelli_design": "kinetica_tpu_torch.analysis.sobol",
    "sobol_indices_from_values": "kinetica_tpu_torch.analysis.sobol",
    "reduce_network_drg": "kinetica_tpu_torch.analysis.reduction",
    "reduce_network_drgep": "kinetica_tpu_torch.analysis.reduction",
    "drg_adjacency": "kinetica_tpu_torch.analysis.reduction",
    "drgep_adjacency": "kinetica_tpu_torch.analysis.reduction",
    "drgep_coefficients": "kinetica_tpu_torch.analysis.reduction",
    "DRGReductionResult": "kinetica_tpu_torch.analysis.reduction",
    "reaction_fluxes": "kinetica_tpu_torch.analysis.flux",
    "EnsembleProblem": "kinetica_tpu_torch.parallel.batching",
    "solve_network_ensemble": "kinetica_tpu_torch.parallel.batching",
    "solve_adjoint_gradient": "kinetica_tpu_torch.solving.adjoint",
    "find_steady_state": "kinetica_tpu_torch.solving.steady_state",
    "find_steady_state_ensemble": "kinetica_tpu_torch.solving.steady_state",
    "steady_state_sensitivities": "kinetica_tpu_torch.solving.steady_state",
    "tconvert": "kinetica_tpu_torch.utils",
    "create_savepoints": "kinetica_tpu_torch.utils",
}

# Names of kinetica_tpu's table whose modules are not ported yet; they
# raise AttributeError here (ROADMAP.md, Queue 1). Every name is ported.
NOT_PORTED = ()


def __getattr__(name):
    if name in _API:
        import importlib
        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(
        f"module 'kinetica_tpu_torch' has no attribute {name!r}")
