"""Time unit conversion and savepoint grids.

Same capability as the reference's time utilities
(Julia reference src/utils.jl:21-115): unit map, ``tconvert``, and a
savepoint range builder that compensates for floating-point error and
always includes the endpoint.
"""
from __future__ import annotations

import numpy as np

t_unit_map: dict[str, float] = {
    "picoseconds": 1.0e-12, "ps": 1.0e-12,
    "nanoseconds": 1.0e-9, "ns": 1.0e-9,
    "microseconds": 1.0e-6, "us": 1.0e-6,
    "milliseconds": 1.0e-3, "ms": 1.0e-3,
    "seconds": 1.0, "s": 1.0,
    "minutes": 60.0, "mins": 60.0,
    "hours": 3600.0, "hrs": 3600.0,
    "days": 86400.0,
    "months": 2.6297368e06, "mts": 2.6297368e06,
    "years": 3.15576e07, "yrs": 3.15576e07,
}


def tconvert(t=None, from_unit: str = "s", to_unit: str = "s"):
    """Convert time(s) between units; with ``t=None`` returns the factor.

    ``tconvert(60.0, "mins", "hrs")`` -> 1.0;
    ``tconvert("mins", "s")`` -> 60.0 (factor form, mirrors the reference's
    two-string method).
    """
    # Factor form: tconvert("mins", "s")
    if isinstance(t, str):
        from_unit, to_unit = t, from_unit
        t = 1.0
    if t is None:
        t = 1.0
    if from_unit not in t_unit_map or to_unit not in t_unit_map:
        raise ValueError("Unknown unit specified in time conversion!")
    factor = t_unit_map[from_unit] / t_unit_map[to_unit]
    if isinstance(t, (list, tuple, np.ndarray)):
        return np.asarray(t, dtype=np.float64) * factor
    return float(t) * factor


def create_savepoints(start: float, stop: float, step: float) -> np.ndarray:
    """Range of savepoints [start, start+step, ...] guaranteed to end at ``stop``.

    Rounds ``step`` to 9 significant digits when it is a large, almost-integer
    value (compensating fp error introduced by ``tconvert``), and appends
    ``stop`` if the range undershoots. Mirrors reference src/utils.jl:108-115.
    """
    if step > 1e-9 and abs(step - np.floor(step)) < 1e-9:
        # round to 9 significant digits
        from math import floor, log10
        ndig = 9 - int(floor(log10(abs(step)))) - 1
        cstep = round(step, ndig)
    else:
        cstep = step
    n = int(np.floor((stop - start) / cstep + 1e-12)) + 1
    r = start + cstep * np.arange(n, dtype=np.float64)
    r = r[r <= stop + 1e-12 * max(abs(stop), 1.0)]
    if len(r) == 0 or r[-1] < stop - 1e-12 * max(abs(stop), 1.0):
        r = np.append(r, stop)
    else:
        r[-1] = min(r[-1], stop)
    return r
