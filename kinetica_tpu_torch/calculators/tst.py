"""Transition-state-theory rate calculation on f64 tensors.

Counterpart of ``kinetica_tpu/calculators/tst.py``; the mathematics is
the same (Julia reference src/ase/calculator.jl:567-778):

* :func:`entropy` — translational + rotational (by geometry class:
  0 monatomic / 1 linear / 2 nonlinear) + electronic + harmonic
  vibrational + pressure-correction terms (calculator.jl:606-651),
* :func:`enthalpy` — potential energy + ZPE + translational/rotational/
  vibrational heat capacities + kB*T (calculator.jl:658-706),
* Eyring equation k = (k_b T / h) exp(dS/R) exp(-dH/RT) with optional
  harmonic k_max cap (calculator.jl:758-772).

Per-species and per-TS quantities live in padded tables (vibrational
modes padded with a mask), so ``k(T, P)`` is one vectorised expression
over every reaction. The JAX package vmaps a scalar-T rate function over
the conditions; here T and P broadcast instead: conditions of shape S give
rates of shape S + (nr,), with T and P carried as ``T[..., None]`` against
the species and TS axes. The calculator keeps device copies of its tables
and of the reactant gathers, made at construction and at ``splice``, so a
call (the continuous ensemble makes one per RHS evaluation) copies nothing
from the host.

Units follow ASE conventions: energies in eV, masses in amu, inertias in
amu Å^2; dS/dH are converted to J/mol/K and J/mol before the Eyring step,
exactly as the reference (calculator.jl:738-741).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.time_units import tconvert
from .base import KineticCalculator

GEOM_MONATOMIC, GEOM_LINEAR, GEOM_NONLINEAR = 0, 1, 2


def _f64(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64, device=dev or x.device)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def entropy(mass, inertias, geometry, symmetry, mult, vib_energies, vib_mask,
            T, P):
    """Ideal-gas entropy in eV/K (vectorised over leading axes).

    Args (broadcastable): mass (amu), inertias (..., 3) (amu Å^2), geometry
    class int, symmetry number, multiplicity, vib_energies (..., V) in eV
    with boolean vib_mask. T (K) and P (Pa) broadcast against the leading
    axes of the tables (pass ``T[..., None]`` for a batch of conditions
    over a table of systems). Tensors on one device, or numbers.
    """
    T = _f64(T)
    mass = _f64(mass, T)
    # translational
    mass_kg = mass * constants.amu
    S_t = (2.0 * math.pi * mass_kg * constants.k * T / constants.hplanck ** 2) ** 1.5
    S_t = S_t * constants.k * T / constants.ref_P
    S_t = constants.kB * (torch.log(S_t) + 2.5)

    # rotational
    inertias_conv = _f64(inertias, T) * constants.amu / (1e10) ** 2
    inertia_max = torch.amax(inertias_conv, dim=-1)
    S_r_lin = (8.0 * math.pi ** 2 * inertia_max * constants.k * T
               / _f64(symmetry, T) / constants.hplanck ** 2)
    S_r_lin = constants.kB * (torch.log(torch.clamp_min(S_r_lin, 1e-300)) + 1.0)
    prod_inertia = torch.prod(torch.clamp_min(inertias_conv, 1e-300), dim=-1)
    S_r_nonlin = torch.sqrt(math.pi * prod_inertia) / _f64(symmetry, T)
    S_r_nonlin = S_r_nonlin * (8.0 * math.pi ** 2 * constants.k * T
                               / constants.hplanck ** 2) ** 1.5
    S_r_nonlin = constants.kB * (torch.log(torch.clamp_min(S_r_nonlin, 1e-300))
                                 + 1.5)
    geometry = torch.as_tensor(geometry, device=T.device)
    S_r = torch.where(geometry == GEOM_LINEAR, S_r_lin,
                      torch.where(geometry == GEOM_NONLINEAR, S_r_nonlin, 0.0))

    # electronic
    S_e = constants.kB * torch.log(_f64(mult, T))

    # vibrational (harmonic), masked over padded modes
    vib_mask = torch.as_tensor(vib_mask, dtype=torch.bool, device=T.device)
    kT = (constants.kB * T)[..., None]
    x = _f64(vib_energies, T) / kT
    x = torch.where(vib_mask, torch.clamp_min(x, 1e-12), 1.0)
    terms = x / torch.expm1(x) - torch.log1p(-torch.exp(-x))
    S_v = constants.kB * torch.sum(torch.where(vib_mask, terms, 0.0), dim=-1)

    # pressure correction
    S_p = -constants.kB * torch.log(_f64(P, T) / constants.ref_P)

    return S_t + S_r + S_e + S_v + S_p


def enthalpy(energy, vib_energies, vib_mask, geometry, T):
    """Ideal-gas enthalpy in eV (vectorised over leading axes; T as in
    :func:`entropy`)."""
    T = _f64(T)
    vib = _f64(vib_energies, T)
    vib_mask = torch.as_tensor(vib_mask, dtype=torch.bool, device=T.device)
    zpe = 0.5 * torch.sum(torch.where(vib_mask, vib, 0.0), dim=-1)
    kT = constants.kB * T
    x = torch.where(vib_mask, torch.clamp_min(vib / kT[..., None], 1e-12), 1.0)
    Cv_vib = torch.sum(torch.where(vib_mask, vib / torch.expm1(x), 0.0), dim=-1)
    geometry = torch.as_tensor(geometry, device=T.device)
    Cv_rot = torch.where(geometry == GEOM_LINEAR, constants.kB * T,
                         torch.where(geometry == GEOM_NONLINEAR,
                                     1.5 * constants.kB * T, 0.0))
    return (_f64(energy, T) + zpe + 1.5 * constants.kB * T + Cv_rot
            + Cv_vib + constants.kB * T)


@dataclass
class ThermoTable:
    """Padded per-system thermochemistry inputs (species or TS ensemble)."""
    mass: np.ndarray            # (n,)
    inertias: np.ndarray        # (n, 3)
    geometry: np.ndarray        # (n,) int 0/1/2
    symmetry: np.ndarray        # (n,)
    mult: np.ndarray            # (n,)
    energy: np.ndarray          # (n,) potential energy, eV
    vib_energies: np.ndarray    # (n, Vmax) eV
    vib_mask: np.ndarray        # (n, Vmax) bool

    @classmethod
    def from_lists(cls, mass, inertias, geometry, symmetry, mult, energy,
                   vib_lists):
        n = len(mass)
        vmax = max([1] + [len(v) for v in vib_lists])
        vibs = np.zeros((n, vmax))
        mask = np.zeros((n, vmax), dtype=bool)
        for i, v in enumerate(vib_lists):
            vibs[i, : len(v)] = v
            mask[i, : len(v)] = True
        return cls(np.asarray(mass, dtype=np.float64),
                   np.asarray(inertias, dtype=np.float64).reshape(n, 3),
                   np.asarray(geometry, dtype=np.int32),
                   np.asarray(symmetry, dtype=np.float64),
                   np.asarray(mult, dtype=np.float64),
                   np.asarray(energy, dtype=np.float64),
                   vibs, mask)

    def to(self, device) -> dict:
        """The table as tensors on ``device`` (f64, int64 geometry, bool
        mask), keyed by field name."""
        out = {name: torch.as_tensor(np.asarray(getattr(self, name),
                                                dtype=np.float64),
                                     device=device)
               for name in ("mass", "inertias", "symmetry", "mult", "energy",
                            "vib_energies")}
        out["geometry"] = torch.as_tensor(
            np.asarray(self.geometry, dtype=np.int64), device=device)
        out["vib_mask"] = torch.as_tensor(
            np.asarray(self.vib_mask, dtype=bool), device=device)
        return out


def _table_thermo(tab: dict, Tb, Pb):
    """(S, H) of every system of a device table at conditions ``Tb``/``Pb``
    (shaped ``S + (1,)``): shapes ``S + (n,)``."""
    S = entropy(tab["mass"], tab["inertias"], tab["geometry"],
                tab["symmetry"], tab["mult"], tab["vib_energies"],
                tab["vib_mask"], Tb, Pb)
    H = enthalpy(tab["energy"], tab["vib_energies"], tab["vib_mask"],
                 tab["geometry"], Tb)
    return S, H


class TSTCalculator(KineticCalculator):
    """Eyring TST rates from tabulated species + TS thermochemistry.

    ``species`` is a ThermoTable over all species; ``ts`` a ThermoTable over
    all reactions' transition states; ``id_reacs``/``stoic_reacs`` give each
    reaction's reactant IDs and stoichiometries (ragged lists, padded
    internally). Conditions: T (K), P (Pa), floats or tensors; conditions
    of shape S give rates of shape S + (nr,) on T's device (the
    calculator's ``device`` for float conditions). Closed-form in T and P,
    so it serves discrete and continuous variable-rate solves.
    """
    allows_continuous = True

    def __init__(self, species: ThermoTable, ts: ThermoTable,
                 id_reacs, stoic_reacs, k_max=None, t_unit: str = "s",
                 device=DEFAULT_DEVICE):
        self.species = species
        self.ts = ts
        nr = len(id_reacs)
        arity = max([1] + [len(r) for r in id_reacs])
        self.reac_ids = np.zeros((nr, arity), dtype=np.int32)
        self.reac_stoic = np.zeros((nr, arity), dtype=np.float64)
        for j, (ids, sts) in enumerate(zip(id_reacs, stoic_reacs)):
            self.reac_ids[j, : len(ids)] = ids
            self.reac_stoic[j, : len(sts)] = sts
        self.k_max = k_max
        self.t_unit = t_unit
        self.t_mult = tconvert(t_unit, "s")
        self.device = resolve_device(device)
        self._to_device()

    def _to_device(self) -> None:
        self._species = self.species.to(self.device)
        self._ts = self.ts.to(self.device)
        self._reac_ids = torch.as_tensor(self.reac_ids.astype(np.int64),
                                         device=self.device)
        self._reac_stoic = torch.as_tensor(self.reac_stoic, device=self.device)

    @property
    def nr(self) -> int:
        return self.reac_ids.shape[0]

    def setup_network(self, sd, rd) -> None:
        if rd.nr != self.nr:
            raise ValueError(
                f"TST tables cover {self.nr} reactions but RxData has {rd.nr}")

    def splice(self, rids) -> None:
        keep = np.setdiff1d(np.arange(self.nr), np.asarray(list(rids), dtype=int))
        self.reac_ids = self.reac_ids[keep]
        self.reac_stoic = self.reac_stoic[keep]
        ts = self.ts
        self.ts = ThermoTable(ts.mass[keep], ts.inertias[keep],
                              ts.geometry[keep], ts.symmetry[keep],
                              ts.mult[keep], ts.energy[keep],
                              ts.vib_energies[keep], ts.vib_mask[keep])
        self._to_device()

    def has_conditions(self, symbols) -> bool:
        return all(s in ("T", "P") for s in symbols)

    def _conditions(self, T, P):
        """T and P as f64 tensors of one broadcast shape, on T's device
        (the calculator's for float conditions)."""
        dev = T.device if isinstance(T, torch.Tensor) else self.device
        T = torch.as_tensor(T, dtype=torch.float64, device=dev)
        P = torch.as_tensor(P, dtype=torch.float64, device=dev)
        shape = torch.broadcast_shapes(T.shape, P.shape)
        return T.expand(shape), P.expand(shape)

    def calculate_entropy_enthalpy(self, T, P):
        """(dS, dH) over all reactions in J/mol/K and J/mol
        (calculator.jl:717-744); conditions of shape S give S + (nr,)."""
        T, P = self._conditions(T, P)
        dev = T.device
        Tb, Pb = T[..., None], P[..., None]
        sp = {k: v.to(dev) for k, v in self._species.items()}
        ts = {k: v.to(dev) for k, v in self._ts.items()}
        ids, stoic = self._reac_ids.to(dev), self._reac_stoic.to(dev)
        S_spec, H_spec = _table_thermo(sp, Tb, Pb)
        # reactant sums via padded gathers (stoich 0 padding contributes 0)
        S_reacs = torch.sum(stoic * S_spec[..., ids], dim=-1)
        H_reacs = torch.sum(stoic * H_spec[..., ids], dim=-1)
        S_ts, H_ts = _table_thermo(ts, Tb, Pb)
        conv = constants.J / constants.mol  # eV -> J/mol divisor
        dS = (S_ts - S_reacs) / conv
        dH = (H_ts - H_reacs) / conv
        return dS, dH

    def __call__(self, T, P, **_):
        T, P = self._conditions(T, P)
        dS, dH = self.calculate_entropy_enthalpy(T, P)
        Tb = T[..., None]
        k_r = (constants.k_b * Tb / constants.h
               * torch.exp(dS / constants.R)
               * torch.exp(-dH / (constants.R * Tb)))
        k = self._apply_k_max(k_r, self.k_max)
        return k * self.t_mult
