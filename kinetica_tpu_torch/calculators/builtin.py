"""Built-in kinetic calculators: Dummy, precalculated Arrhenius, Lindemann.

Counterpart of ``kinetica_tpu/calculators/builtin.py``. Rate constants are
computed with native f64 ``exp`` on the calculator's device. The
reference's pair-precision path (``rates_pair``/``_pair_consts``) exists
because TPU f64 ``exp`` underflows; it is not ported.

The per-reaction parameters stay host numpy arrays (``Ea``, ``A``,
``A_0``, ``A_inf``, ``rates``), as the pure-numpy CPU baseline reads them;
the calculator keeps a device copy for evaluation.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.time_units import tconvert
from .base import KineticCalculator


def _as_f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


class DummyKineticCalculator(KineticCalculator):
    """Returns fixed rates; debugging only (reference calculator.jl:72-158).

    Accepts conditions T (K) and V (dm^3), ignoring their values; the
    result has the conditions' batch shape + (nr,)."""
    allows_continuous = True

    def __init__(self, rates, k_max=None, t_unit: str = "s",
                 device=DEFAULT_DEVICE):
        self.rates = np.asarray(rates, dtype=np.float64)
        self.k_max = k_max
        self.t_unit = t_unit
        self.t_mult = tconvert(t_unit, "s")
        self.device = resolve_device(device)

    def setup_network(self, sd, rd) -> None:
        if len(self.rates) != rd.nr:
            raise ValueError(
                f"Number of rates ({len(self.rates)}) does not match number "
                f"of reactions in RxData ({rd.nr})")

    def splice(self, rids) -> None:
        keep = np.setdiff1d(np.arange(self.rates.shape[0]),
                            np.asarray(list(rids), dtype=int))
        self.rates = self.rates[keep]

    def has_conditions(self, symbols) -> bool:
        return all(s in ("T", "V") for s in symbols)

    def __call__(self, T=None, V=None, **_):
        k = _as_f64(self.rates * self.t_mult, self.device)
        shape = torch.as_tensor(T if T is not None else 0.0).shape
        k = k.expand(shape + k.shape)
        return self._apply_k_max(k, self.k_max) if self.k_max is not None else k


class PrecalculatedArrheniusCalculator(KineticCalculator):
    """k = A exp(-Ea / R T) * N_A * t_mult with optional harmonic k_max cap.

    Parity with reference calculator.jl:164-238 (Ea in J/mol, A in
    mol dm^-3 s^-1 for bimolecular reactions). ``T`` is a float or a
    tensor of any shape; the result has shape ``T.shape + (nr,)`` and lies
    on T's device (the calculator's ``device`` for a float T).
    """
    allows_continuous = True

    def __init__(self, Ea, A, k_max=None, t_unit: str = "s",
                 device=DEFAULT_DEVICE):
        self.Ea = np.asarray(Ea, dtype=np.float64)
        self.A = np.asarray(A, dtype=np.float64)
        self.k_max = k_max
        self.t_unit = t_unit
        self.t_mult = tconvert(t_unit, "s")
        self.device = resolve_device(device)
        self._to_device()

    def _to_device(self) -> None:
        self._Ea = _as_f64(self.Ea, self.device)
        self._A = _as_f64(self.A, self.device)

    def setup_network(self, sd, rd) -> None:
        if len(self.Ea) != rd.nr or len(self.A) != rd.nr:
            raise ValueError(
                f"Number of parameters (Ea: {len(self.Ea)}, A: {len(self.A)}) "
                f"does not match number of reactions in RxData ({rd.nr})")

    def splice(self, rids) -> None:
        keep = np.setdiff1d(np.arange(self.Ea.shape[0]),
                            np.asarray(list(rids), dtype=int))
        self.Ea = self.Ea[keep]
        self.A = self.A[keep]
        self._to_device()

    def has_conditions(self, symbols) -> bool:
        return all(s in ("T",) for s in symbols)

    def __call__(self, T, **_):
        T = _as_f64(T, T.device if isinstance(T, torch.Tensor) else self.device)
        expo = -self._Ea.to(T.device) / (constants.R * T[..., None])
        k = self._A.to(T.device) * torch.exp(expo) * constants.N_A * self.t_mult
        return self._apply_k_max(k, self.k_max)


class PrecalculatedLindemannCalculator(KineticCalculator):
    """Pressure-dependent unimolecular falloff (Lindemann-Hinshelwood).

    The reference declares this calculator but leaves the rate formula
    unimplemented (calculator.jl:307-314 throws); the JAX package, and so
    the port, implement the standard Lindemann form::

        k0    = A_0  exp(-Ea / R T)          (low-pressure limit)
        k_inf = A_inf exp(-Ea / R T)         (high-pressure limit)
        [M]   = P / (R T)  (ideal gas, mol dm^-3)
        k     = k_inf * Pr / (1 + Pr),  Pr = k0 [M] / k_inf

    Conditions: T (K) and P (Pa), floats or tensors of one shape; the
    result has shape ``T.shape + (nr,)``. ``strict_reference_parity=True``
    raises ``NotImplementedError`` instead, as the reference does.
    """
    allows_continuous = True

    def __init__(self, Ea, A_0, A_inf, k_max=None, t_unit: str = "s",
                 strict_reference_parity: bool = False, device=DEFAULT_DEVICE):
        self.Ea = np.asarray(Ea, dtype=np.float64)
        self.A_0 = np.asarray(A_0, dtype=np.float64)
        self.A_inf = np.asarray(A_inf, dtype=np.float64)
        self.k_max = k_max
        self.t_unit = t_unit
        self.t_mult = tconvert(t_unit, "s")
        self.strict_reference_parity = strict_reference_parity
        self.device = resolve_device(device)
        self._to_device()

    def _to_device(self) -> None:
        self._Ea = _as_f64(self.Ea, self.device)
        self._A_0 = _as_f64(self.A_0, self.device)
        self._A_inf = _as_f64(self.A_inf, self.device)

    def setup_network(self, sd, rd) -> None:
        for name, p in (("Ea", self.Ea), ("A_0", self.A_0),
                        ("A_inf", self.A_inf)):
            if len(p) != rd.nr:
                raise ValueError(
                    f"Number of parameters ({name}: {len(p)}) does not match "
                    f"number of reactions in RxData ({rd.nr})")

    def splice(self, rids) -> None:
        keep = np.setdiff1d(np.arange(self.Ea.shape[0]),
                            np.asarray(list(rids), dtype=int))
        self.Ea = self.Ea[keep]
        self.A_0 = self.A_0[keep]
        self.A_inf = self.A_inf[keep]
        self._to_device()

    def has_conditions(self, symbols) -> bool:
        return all(s in ("T", "P") for s in symbols)

    def __call__(self, T, P, **_):
        if self.strict_reference_parity:
            raise NotImplementedError("Lindemann rate constants not implemented yet.")
        dev = T.device if isinstance(T, torch.Tensor) else self.device
        T = _as_f64(T, dev)[..., None]
        P = _as_f64(P, dev)[..., None]
        boltz = torch.exp(-self._Ea.to(dev) / (constants.R * T))
        k0 = self._A_0.to(dev) * boltz
        k_inf = self._A_inf.to(dev) * boltz
        M = P / (constants.R * T) / 1000.0  # mol m^-3 -> mol dm^-3
        pr = k0 * M / k_inf
        k = k_inf * pr / (1.0 + pr) * constants.N_A * self.t_mult
        return self._apply_k_max(k, self.k_max)
