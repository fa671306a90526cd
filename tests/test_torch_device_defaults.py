"""The port's entry points run on the card unless the caller asks for the
CPU: every public ``device=`` defaults to ``"cuda"``, and a call without
``device`` on a machine with no card raises ``RuntimeError`` instead of
running quietly on the CPU.
"""
import inspect

import numpy as np
import pytest
import torch


def _network():
    from kinetica_tpu_torch.testing.synthetic import synthetic_pyrolysis_network
    return synthetic_pyrolysis_network(4)


def _method(sd, rd, Ea, A):
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.conditions.profiles import LinearGradientProfile
    from kinetica_tpu_torch.solving.methods import VariableODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    calc = PrecalculatedArrheniusCalculator(Ea, A, device="cpu")
    cs = ConditionSet({"T": LinearGradientProfile(rate=50.0, X_start=900.0,
                                                  X_end=950.0)})
    pars = ODESimulationParams(tspan=(0.0, 1.0), u0={"C4": 1.0},
                               solve_chunks=True, solve_chunkstep=0.5,
                               low_k_cutoff="none")
    return VariableODESolve(pars, cs, calc), cs


def _solve_network():
    from kinetica_tpu_torch.solving.methods import solve_network
    sd, rd, Ea, A = _network()
    method, _ = _method(sd, rd, Ea, A)
    return solve_network, lambda **kw: solve_network(method, sd, rd, **kw)


def _ensemble_problem():
    from kinetica_tpu_torch.parallel.batching import EnsembleProblem
    sd, rd, Ea, A = _network()
    method, _ = _method(sd, rd, Ea, A)
    return EnsembleProblem, lambda **kw: EnsembleProblem(method, sd, rd, **kw)


def _solve_network_ensemble():
    from kinetica_tpu_torch.parallel.batching import solve_network_ensemble
    sd, rd, Ea, A = _network()
    method, cs = _method(sd, rd, Ea, A)
    return solve_network_ensemble, lambda **kw: solve_network_ensemble(
        method, sd, rd, conditions_list=[cs], **kw)


def _static_method():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    from kinetica_tpu_torch.conditions.condition_set import ConditionSet
    from kinetica_tpu_torch.solving.methods import StaticODESolve
    from kinetica_tpu_torch.solving.params import ODESimulationParams
    sd, rd, Ea, A = _network()
    calc = PrecalculatedArrheniusCalculator(Ea, A, device="cpu")
    pars = ODESimulationParams(tspan=(0.0, 1.0), u0={"C4": 1.0},
                               low_k_cutoff="none")
    return StaticODESolve(pars, ConditionSet({"T": 700.0}), calc), sd, rd


def _find_steady_state():
    from kinetica_tpu_torch.solving.steady_state import find_steady_state
    method, sd, rd = _static_method()
    return find_steady_state, lambda **kw: find_steady_state(method, sd, rd,
                                                             **kw)


def _find_steady_state_ensemble():
    from kinetica_tpu_torch.solving.steady_state import (
        find_steady_state_ensemble)
    method, sd, rd = _static_method()
    return find_steady_state_ensemble, lambda **kw: find_steady_state_ensemble(
        method, sd, rd, [method.conditions], **kw)


def _steady_state_sensitivities():
    from kinetica_tpu_torch.solving.steady_state import (
        steady_state_sensitivities)
    method, sd, rd = _static_method()
    return steady_state_sensitivities, (
        lambda **kw: steady_state_sensitivities(method, sd, rd, **kw))


def _solve_adjoint_gradient():
    from kinetica_tpu_torch.solving.adjoint import solve_adjoint_gradient
    method, sd, rd = _static_method()
    w = np.zeros(sd.n)
    w[0] = 1.0
    return solve_adjoint_gradient, lambda **kw: solve_adjoint_gradient(
        method, sd, rd, w, **kw)


def _dummy():
    from kinetica_tpu_torch.calculators.builtin import DummyKineticCalculator
    return DummyKineticCalculator, lambda **kw: DummyKineticCalculator(
        np.ones(3), **kw)


def _arrhenius():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedArrheniusCalculator)
    return PrecalculatedArrheniusCalculator, (
        lambda **kw: PrecalculatedArrheniusCalculator(np.ones(3), np.ones(3),
                                                      **kw))


def _lindemann():
    from kinetica_tpu_torch.calculators.builtin import (
        PrecalculatedLindemannCalculator)
    return PrecalculatedLindemannCalculator, (
        lambda **kw: PrecalculatedLindemannCalculator(
            np.ones(3), np.ones(3), np.ones(3), **kw))


def _build_mass_action():
    from kinetica_tpu_torch.models.mass_action import build_mass_action
    sd, rd, _, _ = _network()
    return build_mass_action, lambda **kw: build_mass_action(rd, sd.n, **kw)


def _from_numpy():
    from kinetica_tpu_torch.models.mass_action import MassActionNetwork
    return MassActionNetwork.from_numpy, (
        lambda **kw: MassActionNetwork.from_numpy(np.zeros((2, 2), np.int64),
                                                  np.zeros((2, 3)), **kw))


ENTRY_POINTS = {
    "solve_network": _solve_network,
    "EnsembleProblem": _ensemble_problem,
    "solve_network_ensemble": _solve_network_ensemble,
    "DummyKineticCalculator": _dummy,
    "PrecalculatedArrheniusCalculator": _arrhenius,
    "PrecalculatedLindemannCalculator": _lindemann,
    "build_mass_action": _build_mass_action,
    "MassActionNetwork.from_numpy": _from_numpy,
    "find_steady_state": _find_steady_state,
    "find_steady_state_ensemble": _find_steady_state_ensemble,
    "steady_state_sensitivities": _steady_state_sensitivities,
    "solve_adjoint_gradient": _solve_adjoint_gradient,
}

# entry points whose CPU run is a whole solve: covered by their own tests
SOLVES = ("solve_network", "solve_network_ensemble", "find_steady_state",
          "find_steady_state_ensemble", "steady_state_sensitivities",
          "solve_adjoint_gradient")


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    fn, _ = ENTRY_POINTS[name]()
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_call_without_device_needs_a_card(name, monkeypatch):
    """No card (as on the CPU test machines, and forced here so the test
    means the same everywhere): the default raises; the CPU on request
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, call = ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        call()
    if name not in SOLVES:
        call(device="cpu")
