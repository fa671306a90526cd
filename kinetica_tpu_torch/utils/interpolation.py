"""Time-series container with linear interpolation.

TPU-native analog of the reference's ``DiffEqArray`` + linear-interp functor
(Julia reference src/utils.jl:135-139 and RecursiveArrayTools). Stores a
time grid ``t`` (shape (nt,)) and values ``u`` (shape (nt, ...)) as plain
numpy arrays on the host; calling the object interpolates (linearly, with
left-continuity at exact knots) at new times. Device-side interpolation for
traced code lives in :mod:`kinetica_tpu.ops.interp` (not ported yet).
"""
from __future__ import annotations

import numpy as np


class TimeSeries:
    """Immutable (t, u) series supporting call-style linear interpolation.

    ``u`` rows correspond to times in ``t``. ``ts(tq)`` returns the linear
    interpolation at ``tq`` (scalar or array). Queries outside the grid clamp
    to the end values (the reference errors instead; clamping is safer for
    fp-edge queries at t_end and is exercised deliberately by chunk mapping).
    """

    def __init__(self, t, u):
        self.t = np.asarray(t, dtype=np.float64)
        self.u = np.asarray(u)
        if self.t.ndim != 1:
            raise ValueError("t must be 1-D")
        if self.u.shape[0] != self.t.shape[0]:
            raise ValueError("u must have one row per time point")

    def __len__(self):
        return len(self.t)

    def __call__(self, tq):
        tq_arr = np.asarray(tq, dtype=np.float64)
        scalar = tq_arr.ndim == 0
        tqs = np.atleast_1d(tq_arr)
        tqs = np.clip(tqs, self.t[0], self.t[-1])
        idx = np.searchsorted(self.t, tqs, side="right") - 1
        idx = np.clip(idx, 0, len(self.t) - 2)
        t0, t1 = self.t[idx], self.t[idx + 1]
        w = np.where(t1 > t0, (tqs - t0) / np.where(t1 > t0, t1 - t0, 1.0), 0.0)
        shape_tail = (1,) * (self.u.ndim - 1)
        w = w.reshape(w.shape + shape_tail)
        out = (1.0 - w) * self.u[idx] + w * self.u[idx + 1]
        return out[0] if scalar else out

    def min(self):
        return float(np.min(self.u))

    def max(self):
        return float(np.max(self.u))

    def __repr__(self):
        return f"TimeSeries(nt={len(self.t)}, shape={self.u.shape})"
