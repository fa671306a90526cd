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

Ported: static, null/linear direct, null/linear gradient, the double-ramp
gradient profile (blended or not) and the sawtooth direct profile: every
profile class of the reference.
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


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``x`` clipped to [lo, hi]; the bounds are floats or tensors."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


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


class DoubleRampGradientProfile(GradientProfile):
    """Two ramps with three plateaus and optional gradient blending
    (gradient_variable.jl:181-309)::

                      ------   X_mid
              rate1  /      \\
                    /        \\  rate2
        X_start ----          \\
                               ----- X_end

    With ``t_blend`` the gradient ramps linearly over +-t_blend around each
    corner, and ``value`` is its exact antiderivative (quadratic ease-in
    and ease-out). ``blended`` selects the form, so members of one batch
    must agree on it (``static_attrs``).
    """

    theta_fields = ("X_start", "X_mid", "X_end", "rate1", "rate2",
                    "t_startr1", "t_endr1", "t_startr2", "t_endr2", "t_blend")
    static_attrs = ("blended",)

    def __init__(self, X_start: float, t_start_plateau: float, rate1: float,
                 X_mid: float, t_mid_plateau: float, rate2: float, X_end: float,
                 t_end_plateau: float, t_blend: float | None = None):
        super().__init__()
        if ((X_mid > X_start and rate1 < 0) or (X_mid < X_start and rate1 > 0)
                or (X_end > X_mid and rate2 < 0) or (X_end < X_mid and rate2 > 0)):
            raise ValueError("Impossible condition ramp defined. "
                             "Check heating rates have the correct signs.")
        self.X_start, self.X_mid, self.X_end = (float(X_start), float(X_mid),
                                                float(X_end))
        self.rate1, self.rate2 = float(rate1), float(rate2)
        self.t_start_plateau = float(t_start_plateau)
        self.t_mid_plateau = float(t_mid_plateau)
        self.t_end_plateau = float(t_end_plateau)
        self.t_startr1 = float(t_start_plateau)
        self.t_endr1 = self.t_startr1 + (X_mid - X_start) / rate1
        self.t_startr2 = self.t_endr1 + t_mid_plateau
        self.t_endr2 = self.t_startr2 + (X_end - X_mid) / rate2
        self.t_end = self.t_endr2 + t_end_plateau
        self.t_blend = 0.0 if t_blend is None else float(t_blend)
        self.blended = t_blend is not None
        if not self.blended:
            self.tstops = np.array([self.t_startr1, self.t_endr1,
                                    self.t_startr2, self.t_endr2, self.t_end])
        else:
            b = self.t_blend
            self.tstops = np.array([
                self.t_startr1 - b, self.t_startr1 + b,
                self.t_endr1 - b, self.t_endr1 + b,
                self.t_startr2 - b, self.t_startr2 + b,
                self.t_endr2 - b, self.t_endr2 + b,
                self.t_end])

    def grad(self, t):
        t = _as_time(t)
        ts1, te1 = self.t_startr1, self.t_endr1
        ts2, te2 = self.t_startr2, self.t_endr2
        r1, r2 = self.rate1, self.rate2
        if not self.blended:
            return (((t >= ts1) & (t < te1)) * r1
                    + ((t >= ts2) & (t < te2)) * r2)
        b = self.t_blend
        return (
            ((t >= ts1 - b) & (t < ts1 + b)) * (r1 * (t - ts1 - b) / (2 * b) + r1)
            + ((t >= ts1 + b) & (t < te1 - b)) * r1
            + ((t >= te1 - b) & (t < te1 + b)) * (-r1 * (t - te1 - b) / (2 * b))
            + ((t >= ts2 - b) & (t < ts2 + b)) * (r2 * (t - ts2 - b) / (2 * b) + r2)
            + ((t >= ts2 + b) & (t < te2 - b)) * r2
            + ((t >= te2 - b) & (t < te2 + b)) * (-r2 * (t - te2 - b) / (2 * b)))

    def value(self, t):
        t = _as_time(t)
        zero = torch.zeros_like(t)
        ts1, te1 = self.t_startr1, self.t_endr1
        ts2, te2 = self.t_startr2, self.t_endr2
        r1, r2 = self.rate1, self.rate2
        X0, Xm, Xe = self.X_start, self.X_mid, self.X_end
        if not self.blended:
            return torch.where(
                t < ts1, X0 + zero,
                torch.where(t < te1, X0 + r1 * (t - ts1),
                            torch.where(t < ts2, Xm + zero,
                                        torch.where(t < te2, Xm + r2 * (t - ts2),
                                                    Xe + zero))))
        b = self.t_blend

        def ramp_value(t_on, t_off, X_lo, rate):
            tau_on = _clip(t - (t_on - b), 0.0, 2 * b)       # rising blend
            tau_mid = _clip(t - (t_on + b), 0.0, (t_off - b) - (t_on + b))
            tau_off = _clip(t - (t_off - b), 0.0, 2 * b)     # falling blend
            return (X_lo + rate * tau_on ** 2 / (4 * b) + rate * tau_mid
                    + rate * (tau_off - tau_off ** 2 / (4 * b)))

        return torch.where(t < ts2 - b, ramp_value(ts1, te1, X0, r1),
                           ramp_value(ts2, te2, Xm, r2))

    def create_discrete_tstops(self, ts_update: float) -> None:
        """Stops only where the profile varies (gradient_variable.jl:301-309)."""
        if ts_update > self.t_end:
            raise ValueError("Error defining tstops, `ts_update` is too large.")
        b = self.t_blend
        self.tstops = np.concatenate([
            [0.0],
            create_savepoints(self.t_startr1 - b, self.t_endr1 + b, ts_update),
            create_savepoints(self.t_startr2 - b, self.t_endr2 + b, ts_update),
            [self.t_end],
        ])


class SawtoothDirectProfile(DirectProfile):
    """Periodic sawtooth ramp about ``X_mid``: rises from X_mid - amplitude
    to X_mid + amplitude over ``period`` and resets, ``n_periods`` times;
    ``X_start`` before t = 0, the top value from ``t_end`` on."""

    theta_fields = ("amplitude", "period", "X_mid", "X_start", "t_end")

    def __init__(self, amplitude: float, period: float, X_mid: float,
                 n_periods: int = 1, X_start: float | None = None):
        super().__init__()
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.X_mid = float(X_mid)
        self.n_periods = int(n_periods)
        self.X_start = (self.X_mid - self.amplitude if X_start is None
                        else float(X_start))
        self.t_end = self.period * self.n_periods
        # discontinuities at every period boundary
        self.tstops = np.arange(1, self.n_periods + 1) * self.period

    def f(self, t):
        t = _as_time(t)
        zero = torch.zeros_like(t)
        # the clipped time is >= 0, where fmod (exact) is the floor modulo
        phase = torch.fmod(_clip(t, 0.0, self.t_end), self.period) / self.period
        val = (self.X_mid - self.amplitude) + 2 * self.amplitude * phase
        return torch.where(t >= self.t_end, self.X_mid + self.amplitude + zero,
                           torch.where(t <= 0.0, self.X_start + zero, val))

    def create_discrete_tstops(self, ts_update: float) -> None:
        if ts_update > self.t_end:
            raise ValueError("Error defining tstops, `ts_update` is too large.")
        self.tstops = np.unique(np.concatenate([
            create_savepoints(0.0, self.t_end, ts_update),
            np.arange(1, self.n_periods + 1) * self.period]))


# Trait helpers mirroring the reference's isstatic/isvariable/etc.
def isstatic(p: AbstractProfile) -> bool:
    return p.is_static


def isvariable(p: AbstractProfile) -> bool:
    return p.is_variable


def isgradientprofile(p: AbstractProfile) -> bool:
    return p.is_gradient


def isdirectprofile(p: AbstractProfile) -> bool:
    return p.is_direct
