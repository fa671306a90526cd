"""Independent cross-checks of the TST thermochemistry math.

Capability parity with the reference's ASE-thermochemistry interface
(Julia reference src/ase/asethermo_interface.jl:1-76): a development-only
validation path that recomputes ideal-gas entropy/enthalpy with *other*
implementations and compares them against :mod:`kinetica_tpu_torch.calculators.tst`.
"Not intended for production use" (asethermo_interface.jl:3) — use it in
tests and when authoring new thermo terms.

Two independent references are provided:

* :func:`numpy_entropy` / :func:`numpy_enthalpy` — a from-scratch numpy
  implementation of the same ideal-gas statistical mechanics (always
  available; a genuinely separate code path from the vectorised, padded,
  torch formulation in ``calculators/tst.py``).
* :func:`asethermo_entropy` / :func:`asethermo_enthalpy` — ASE's own
  ``ase.thermochemistry.IdealGasThermo`` (requires the optional ``ase``
  dependency, exactly as the reference built the Python object through its
  bridge, asethermo_interface.jl:20-40).

:func:`cross_check` runs whichever references are importable and returns a
report of absolute deviations.
"""
from __future__ import annotations

import math

import numpy as np

from .. import constants

GEOM_NAMES = {0: "monatomic", 1: "linear", 2: "nonlinear"}


# ---------------------------------------------------------------------------
# Reference 1: from-scratch numpy ideal-gas thermo (scalar, loop-based —
# deliberately structured differently from the padded torch implementation)
# ---------------------------------------------------------------------------

def numpy_entropy(mass: float, inertias, geometry: int, symmetry: float,
                  mult: float, vib_energies, T: float, P: float) -> float:
    """Ideal-gas entropy (eV/K) for one species; mirrors calculator.jl:606-651."""
    kB, k, hp = constants.kB, constants.k, constants.hplanck
    # translational
    mass_kg = mass * constants.amu
    q_t = (2.0 * math.pi * mass_kg * k * T / hp ** 2) ** 1.5 * k * T / constants.ref_P
    S = kB * (math.log(q_t) + 2.5)
    # rotational
    inertias_si = [i * constants.amu * 1e-20 for i in np.atleast_1d(inertias)]
    if geometry == 1:  # linear
        q_r = 8.0 * math.pi ** 2 * max(inertias_si) * k * T / (symmetry * hp ** 2)
        S += kB * (math.log(q_r) + 1.0)
    elif geometry == 2:  # nonlinear
        prod_i = 1.0
        for i in inertias_si:
            prod_i *= i
        q_r = math.sqrt(math.pi * prod_i) / symmetry
        q_r *= (8.0 * math.pi ** 2 * k * T / hp ** 2) ** 1.5
        S += kB * (math.log(q_r) + 1.5)
    # electronic
    S += kB * math.log(mult)
    # vibrational
    for e in np.atleast_1d(vib_energies):
        x = e / (kB * T)
        S += kB * (x / math.expm1(x) - math.log1p(-math.exp(-x)))
    # pressure correction
    S += -kB * math.log(P / constants.ref_P)
    return S


def numpy_enthalpy(energy: float, vib_energies, geometry: int,
                   T: float) -> float:
    """Ideal-gas enthalpy (eV) for one species; mirrors calculator.jl:658-706."""
    kB = constants.kB
    H = energy
    for e in np.atleast_1d(vib_energies):
        H += 0.5 * e                                  # ZPE
        H += e / math.expm1(e / (kB * T))             # vibrational Cv
    H += 1.5 * kB * T                                 # translational Cv
    if geometry == 1:
        H += kB * T                                   # rotational Cv, linear
    elif geometry == 2:
        H += 1.5 * kB * T                             # rotational Cv, nonlinear
    H += kB * T                                       # H = U + PV = U + kB T
    return H


# ---------------------------------------------------------------------------
# Reference 2: ASE IdealGasThermo (optional dependency)
# ---------------------------------------------------------------------------

def _require_ase():
    try:
        from ase.thermochemistry import IdealGasThermo  # noqa: F401
        return IdealGasThermo
    except ImportError as exc:  # pragma: no cover - env without ase
        raise ImportError(
            "ase is required for the IdealGasThermo cross-check; install it "
            "or use the always-available numpy_entropy/numpy_enthalpy "
            "references") from exc


def make_idealgas_thermo(frame, vib_energies, geometry: int, symmetry: float,
                         mult: float, energy: float = 0.0):
    """Build ``ase.thermochemistry.IdealGasThermo`` from a kinetica frame.

    Mirrors the reference's constructor call (asethermo_interface.jl:20-40):
    geometry class maps to ASE's string convention and spin is (mult-1)/2.
    """
    IdealGasThermo = _require_ase()
    from .conversion import frame_to_atoms

    return IdealGasThermo(
        vib_energies=list(np.atleast_1d(vib_energies)),
        geometry=GEOM_NAMES[int(geometry)],
        potentialenergy=float(energy),
        atoms=frame_to_atoms(frame),
        symmetrynumber=float(symmetry),
        spin=(float(mult) - 1.0) / 2.0,
        ignore_imag_modes=False)


def asethermo_entropy(frame, vib_energies, geometry, symmetry, mult,
                      T: float, P: float) -> float:
    """Entropy (eV/K) via ASE's IdealGasThermo (requires ase)."""
    thermo = make_idealgas_thermo(frame, vib_energies, geometry, symmetry, mult)
    return float(thermo.get_entropy(temperature=T, pressure=P, verbose=False))


def asethermo_enthalpy(frame, vib_energies, geometry, energy,
                       T: float) -> float:
    """Enthalpy (eV) via ASE's IdealGasThermo (requires ase)."""
    IdealGasThermo = _require_ase()
    thermo = IdealGasThermo(
        vib_energies=list(np.atleast_1d(vib_energies)),
        geometry=GEOM_NAMES[int(geometry)],
        potentialenergy=float(energy),
        ignore_imag_modes=False)
    return float(thermo.get_enthalpy(temperature=T, verbose=False))


# ---------------------------------------------------------------------------
# The cross-check entry point
# ---------------------------------------------------------------------------

def cross_check(mass, inertias, geometry, symmetry, mult, energy,
                vib_energies, T: float, P: float, frame=None) -> dict:
    """Compare the port's torch TST thermo against the independent references.

    Returns a dict with the kinetica values, the numpy-reference values,
    their absolute deviations, and (when ase is importable and ``frame`` is
    given) the ASE IdealGasThermo values and deviations.
    """
    from ..calculators import tst

    vibs = np.atleast_1d(np.asarray(vib_energies, dtype=np.float64))
    mask = np.ones(vibs.shape, dtype=bool)
    S_kin = float(tst.entropy(mass, np.asarray(inertias, dtype=np.float64),
                              int(geometry), float(symmetry), float(mult),
                              vibs, mask, T, P))
    H_kin = float(tst.enthalpy(float(energy), vibs, mask, int(geometry), T))
    S_np = numpy_entropy(mass, inertias, int(geometry), symmetry, mult,
                         vibs, T, P)
    H_np = numpy_enthalpy(float(energy), vibs, int(geometry), T)
    report = {
        "S_kinetica": S_kin, "H_kinetica": H_kin,
        "S_numpy": S_np, "H_numpy": H_np,
        "dS_numpy": abs(S_kin - S_np), "dH_numpy": abs(H_kin - H_np),
    }
    if frame is not None:
        try:
            report["S_ase"] = asethermo_entropy(
                frame, vibs, geometry, symmetry, mult, T, P)
            report["H_ase"] = asethermo_enthalpy(
                frame, vibs, geometry, float(energy), T)
            report["dS_ase"] = abs(S_kin - report["S_ase"])
            report["dH_ase"] = abs(H_kin - report["H_ase"])
        except ImportError:
            pass
    return report
