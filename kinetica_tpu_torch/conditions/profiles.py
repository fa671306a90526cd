"""Condition profiles: static values and time-varying ramps, in PyTorch.

Counterpart of ``kinetica_tpu/conditions/profiles.py``. A profile is
static (a constant), direct (a closed form X(t)) or gradient (defined by
dX/dt, here with its exact antiderivative). ``value(t)`` takes a float or
a tensor and returns an f64 tensor on t's device.

Batched evaluation: ``theta_fields`` lists the float attributes that
``value`` reads. ``value_theta(t, theta)`` evaluates a whole ensemble of
same-class profiles at once from a (B, p) parameter tensor and (B,) times;
the continuous rate mode of :mod:`kinetica_tpu_torch.parallel.batching`
builds k(T(t, theta)) this way.

Ported: static, null/linear direct and null/linear gradient profiles. The
double-ramp and sawtooth profiles are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.interpolation import TimeSeries
from ..utils.time_units import create_savepoints


def _as_time(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64)
    return torch.as_tensor(np.asarray(t, dtype=np.float64))


class AbstractProfile:
    is_static = False
    is_variable = False
    is_gradient = False
    is_direct = False

    theta_fields: tuple = ()
    static_attrs: tuple = ()

    def theta(self) -> np.ndarray:
        """Numeric parameter vector consumed by :meth:`value_theta`."""
        if not self.theta_fields:
            raise NotImplementedError(
                f"{type(self).__name__} does not define theta_fields; "
                "batched continuous evaluation is unavailable for it.")
        return np.array([float(getattr(self, f)) for f in self.theta_fields])

    def static_key(self) -> tuple:
        """Profiles sharing this key can be evaluated as one batch."""
        return (type(self).__name__,) + tuple(
            getattr(self, f) for f in self.static_attrs)

    @classmethod
    def value_theta(cls, t, theta: torch.Tensor, static_vals: tuple = ()):
        """Evaluate at ``t`` (B,) from a (B, p) theta tensor."""
        if not cls.theta_fields:
            raise NotImplementedError(
                f"{cls.__name__} does not define theta_fields.")
        obj = object.__new__(cls)
        for name, v in zip(cls.static_attrs, static_vals):
            setattr(obj, name, v)
        for i, name in enumerate(cls.theta_fields):
            setattr(obj, name, theta[..., i])
        return obj.value(t)


class StaticConditionProfile(AbstractProfile):
    """Constant condition (reference static.jl:7-9)."""
    is_static = True
    theta_fields = ("value",)

    def __init__(self, value: float):
        self.value = float(value)

    @classmethod
    def value_theta(cls, t, theta, static_vals: tuple = ()):
        t = torch.as_tensor(t, dtype=torch.float64, device=theta.device)
        return theta[..., 0] * torch.ones_like(t)

    def __repr__(self):
        return f"StaticConditionProfile({self.value})"


class VariableProfile(AbstractProfile):
    """Base for time-varying profiles; carries tstops and a solved series."""
    is_variable = True

    X_start: float
    t_end: float

    def __init__(self):
        self.tstops: np.ndarray = np.array([])
        self.sol: TimeSeries | None = None

    def value(self, t):
        raise NotImplementedError

    def create_discrete_tstops(self, ts_update: float) -> None:
        """Default: uniform stops every ``ts_update`` over [0, t_end]."""
        if ts_update > self.t_end:
            raise ValueError("Error defining tstops, `ts_update` is too large.")
        self.tstops = create_savepoints(0.0, self.t_end, ts_update)

    def solve(self, pars, reset: bool = False) -> None:
        """Tabulate the profile over ``pars.tspan`` into ``self.sol`` (host)."""
        if self.sol is not None and not reset:
            return
        save_interval = (pars.save_interval if pars.save_interval is not None
                         else pars.tspan[1] / 1000)
        t = create_savepoints(pars.tspan[0], pars.tspan[1], save_interval)
        if len(self.tstops):
            t = np.unique(np.concatenate([t, np.asarray(self.tstops, dtype=np.float64)]))
        u = self.value(_as_time(t)).cpu().numpy()
        self.sol = TimeSeries(t, u)

    def minimum(self) -> float:
        if self.sol is None:
            raise RuntimeError("Condition profile is missing a solution.")
        return self.sol.min()

    def maximum(self) -> float:
        if self.sol is None:
            raise RuntimeError("Condition profile is missing a solution.")
        return self.sol.max()


class DirectProfile(VariableProfile):
    """Profile defined by a closed-form f(t) (direct_variable.jl)."""
    is_direct = True

    def f(self, t):
        raise NotImplementedError

    def value(self, t):
        return self.f(t)


class GradientProfile(VariableProfile):
    """Profile defined by dX/dt(t) (gradient_variable.jl).

    Subclasses provide ``grad(t)`` and, when possible, an exact ``value(t)``;
    otherwise (``_needs_numeric=True``) ``solve`` integrates ``grad`` on a
    dense host grid and ``value`` interpolates that table.
    """
    is_gradient = True
    _needs_numeric = False

    def grad(self, t):
        raise NotImplementedError

    def value(self, t):
        if not self._needs_numeric:
            raise NotImplementedError
        if self.sol is None:
            raise RuntimeError("Numeric gradient profile must be solved first.")
        t = _as_time(t)
        return torch.as_tensor(self.sol(t.cpu().numpy()), dtype=torch.float64,
                               device=t.device)

    def solve(self, pars, reset: bool = False) -> None:
        if not self._needs_numeric:
            return super().solve(pars, reset=reset)
        if self.sol is not None and not reset:
            return
        save_interval = (pars.save_interval if pars.save_interval is not None
                         else pars.tspan[1] / 1000)
        t = create_savepoints(pars.tspan[0], pars.tspan[1], save_interval)
        if len(self.tstops):
            t = np.unique(np.concatenate([t, np.asarray(self.tstops, dtype=np.float64)]))
        # Simpson's rule on each interval (midpoint sampling)
        g = self.grad(_as_time(t)).cpu().numpy()
        tm = 0.5 * (t[:-1] + t[1:])
        gm = self.grad(_as_time(tm)).cpu().numpy()
        dt = np.diff(t)
        increments = dt / 6.0 * (g[:-1] + 4.0 * gm + g[1:])
        u = self.X_start + np.concatenate([[0.0], np.cumsum(increments)])
        self.sol = TimeSeries(t, u)


class NullDirectProfile(DirectProfile):
    """Debug profile: X(t) = X_start always (direct_variable.jl:49-92)."""

    theta_fields = ("X_start",)

    def __init__(self, X_start: float, t_end: float):
        super().__init__()
        self.X_start = float(X_start)
        self.t_end = float(t_end)
        self.tstops = np.array([self.t_end])

    def f(self, t):
        t = _as_time(t)
        return self.X_start + torch.zeros_like(t)


class LinearDirectProfile(DirectProfile):
    """Linear ramp X_start -> X_end at ``rate`` (direct_variable.jl:107-155)."""

    theta_fields = ("rate", "X_start", "X_end", "t_end")

    def __init__(self, rate: float, X_start: float, X_end: float):
        super().__init__()
        if (X_end < X_start and rate > 0) or (X_end > X_start and rate < 0):
            raise ValueError("Impossible condition ramp defined. "
                             "Check heating rates have the correct signs.")
        self.rate = float(rate)
        self.X_start = float(X_start)
        self.X_end = float(X_end)
        self.t_end = (X_end - X_start) / rate
        self.tstops = np.array([self.t_end])

    def f(self, t):
        t = _as_time(t)
        ramp = self.X_start + self.rate * t
        return torch.where(t <= 0.0, self.X_start + torch.zeros_like(t),
                           torch.where(t <= self.t_end, ramp,
                                       self.X_end + torch.zeros_like(t)))


class NullGradientProfile(GradientProfile):
    """Debug profile: dX/dt = 0 (gradient_variable.jl:70-114)."""

    theta_fields = ("X_start",)

    def __init__(self, X_start: float, t_end: float):
        super().__init__()
        self.X_start = float(X_start)
        self.t_end = float(t_end)
        self.tstops = np.array([self.t_end])

    def grad(self, t):
        return torch.zeros_like(_as_time(t))

    def value(self, t):
        t = _as_time(t)
        return self.X_start + torch.zeros_like(t)


class LinearGradientProfile(GradientProfile):
    """dX/dt = rate until X_end is reached (gradient_variable.jl:120-175)."""

    theta_fields = ("rate", "X_start", "X_end", "t_end")

    def __init__(self, rate: float, X_start: float, X_end: float):
        super().__init__()
        if (X_end < X_start and rate > 0) or (X_end > X_start and rate < 0):
            raise ValueError("Impossible condition ramp defined. "
                             "Check heating rates have the correct signs.")
        self.rate = float(rate)
        self.X_start = float(X_start)
        self.X_end = float(X_end)
        self.t_end = (X_end - X_start) / rate
        self.tstops = np.array([self.t_end])

    def grad(self, t):
        t = _as_time(t)
        return torch.where(t <= self.t_end, self.rate + torch.zeros_like(t),
                           torch.zeros_like(t))

    def value(self, t):
        t = _as_time(t)
        return torch.where(t <= self.t_end, self.X_start + self.rate * t,
                           self.X_end + torch.zeros_like(t))


# Trait helpers mirroring the reference's isstatic/isvariable/etc.
def isstatic(p: AbstractProfile) -> bool:
    return p.is_static


def isvariable(p: AbstractProfile) -> bool:
    return p.is_variable
