"""ConditionSet: binds condition symbols to profiles.

Same capability as the Julia reference (src/conditions/condition_set.jl):
numbers auto-wrap as static profiles; providing ``ts_update`` enables
discrete rate updates and triggers tstop generation on every variable
profile; accessors produce initial/static/variable condition maps and merged
sorted-unique tstops. The reference's runtime ``@register_symbolic`` step
(condition_set.jl:204-232) is unnecessary here — profile functions are
already jit-traceable jnp code.

Condition symbols are plain strings ("T", "P", "V", ...).
"""
from __future__ import annotations

import numpy as np

from .profiles import AbstractProfile, StaticConditionProfile, VariableProfile


class ConditionSet:
    def __init__(self, d: dict[str, object], ts_update: float | None = None):
        self.symbols: list[str] = []
        self.profiles: list[AbstractProfile] = []
        for sym, prof in d.items():
            if isinstance(prof, (int, float)):
                prof = StaticConditionProfile(float(prof))
            elif isinstance(prof, AbstractProfile):
                if ts_update is not None and isinstance(prof, VariableProfile):
                    prof.create_discrete_tstops(ts_update)
            else:
                raise ValueError(f"Condition {sym} does not have a valid profile.")
            self.symbols.append(str(sym))
            self.profiles.append(prof)
        self.discrete_updates = ts_update is not None
        self.ts_update = ts_update

    # -- lookups --
    def get_profile(self, sym: str) -> AbstractProfile:
        if sym not in self.symbols:
            raise KeyError(f"Condition {sym} does not exist in this ConditionSet")
        return self.profiles[self.symbols.index(sym)]

    def isstatic(self, sym: str | None = None) -> bool:
        if sym is not None:
            return self.get_profile(sym).is_static
        return all(p.is_static for p in self.profiles)

    def isvariable(self, sym: str | None = None) -> bool:
        if sym is not None:
            return self.get_profile(sym).is_variable
        return all(p.is_variable for p in self.profiles)

    # -- condition maps (reference condition_set.jl:110-176) --
    def get_initial_conditions(self) -> dict[str, float]:
        return {s: (p.value if p.is_static else p.X_start)
                for s, p in zip(self.symbols, self.profiles)}

    def get_static_conditions(self) -> dict[str, float]:
        return {s: p.value for s, p in zip(self.symbols, self.profiles) if p.is_static}

    def get_variable_conditions(self) -> dict[str, object]:
        return {s: p.sol for s, p in zip(self.symbols, self.profiles) if p.is_variable}

    def get_variable_profiles(self) -> dict[str, VariableProfile]:
        return {s: p for s, p in zip(self.symbols, self.profiles) if p.is_variable}

    def get_tstops(self) -> np.ndarray:
        """Merged, sorted, unique tstops over all variable profiles."""
        if self.isstatic():
            raise RuntimeError("No tstops available, all conditions in "
                               "ConditionSet are static.")
        all_ts = np.concatenate([np.asarray(p.tstops, dtype=np.float64)
                                 for p in self.profiles if p.is_variable])
        return np.unique(all_ts)

    def get_t_final(self) -> float:
        if self.isstatic():
            raise RuntimeError("No t_end available, all conditions in "
                               "ConditionSet are static.")
        return max(p.t_end for p in self.profiles if p.is_variable)

    def solve_variable_conditions(self, pars, reset: bool = False) -> None:
        """Solve/tabulate every variable profile over pars.tspan
        (condition_set.jl:260-268)."""
        for p in self.profiles:
            if p.is_variable:
                p.solve(pars, reset=reset)

    # -- traceable evaluation for continuous-mode solves --
    def conditions_at(self, t):
        """dict sym -> traceable condition value(s) at time(s) ``t``.

        Static profiles broadcast their constant; variable profiles use their
        closed-form ``value`` (or interpolated solution for numeric ones).
        """
        out = {}
        for s, p in zip(self.symbols, self.profiles):
            out[s] = p.value if p.is_static else p.value(t)
        return out


# Convenience trait functions matching the reference API
def get_t_final(cs: ConditionSet) -> float:
    return cs.get_t_final()


def get_tstops(cs: ConditionSet) -> np.ndarray:
    return cs.get_tstops()


def get_profile(cs: ConditionSet, sym: str) -> AbstractProfile:
    return cs.get_profile(sym)


def solve_variable_conditions(cs: ConditionSet, pars, reset: bool = False) -> None:
    cs.solve_variable_conditions(pars, reset=reset)
