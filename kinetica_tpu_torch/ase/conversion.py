"""Frame <-> ase.Atoms conversion (ASE-gated).

Capability parity with Julia reference src/ase/conversion.jl: frames carry
initial charges/magmoms into Atoms (conversion.jl:16-36), Atoms come back
as frames with energies/inertias (conversion.jl:50-64), and
:func:`imaginary_ve_tol` converts an imaginary-frequency tolerance into
the eV energy magnitude ASE reports (conversion.jl:70-74).
"""
from __future__ import annotations

import math

import numpy as np

from .. import constants
from ..chem import backends, frame_positions, frame_species, make_frame

INVCM_TO_EV = 1.23984193e-4  # 1 cm^-1 in eV


def frame_to_atoms(frame, formal_charges=None, initial_magmoms=None):
    """Build an ase.Atoms from a frame (conversion.jl:16-36)."""
    backends.require("ase", backends.HAS_ASE, "ASE Atoms conversion")
    from ase import Atoms
    atoms = Atoms(symbols="".join(frame_species(frame)),
                  positions=frame_positions(frame))
    if formal_charges is not None:
        atoms.set_initial_charges(np.asarray(formal_charges, dtype=float))
    if initial_magmoms is not None:
        atoms.set_initial_magnetic_moments(
            np.asarray(initial_magmoms, dtype=float))
    return atoms


def atoms_to_frame(atoms, energy=None, inertias=None):
    """Build a frame from an ase.Atoms (conversion.jl:50-64)."""
    backends.require("ase", backends.HAS_ASE, "ASE Atoms conversion")
    frame = make_frame([str(s) for s in atoms.get_chemical_symbols()],
                       np.asarray(atoms.get_positions()))
    if energy is None:
        try:
            energy = float(atoms.get_potential_energy())
        except Exception:
            energy = None
    if energy is not None:
        frame["info"]["energy_ASE"] = energy
    if inertias is None:
        try:
            inertias = np.asarray(atoms.get_moments_of_inertia())
        except Exception:
            inertias = None
    if inertias is not None:
        frame["arrays"]["inertias"] = np.asarray(inertias).tolist()
    return frame


def imaginary_ve_tol(imaginary_freq_tol: float) -> float:
    """Imaginary-frequency tolerance -> imaginary vibrational-energy
    tolerance in eV (conversion.jl:70-74): ``tol^-1/2 * hbar * 1e10 /
    sqrt(e * amu)`` — the energy of a mode whose force constant is
    ``1/tol`` eV/A^2. Golden: imaginary_ve_tol(1e-3) ==
    2.0445437750827997 (reference test/Python/ase.jl:16)."""
    return (float(imaginary_freq_tol) ** -0.5) * constants.hbar * 1e10 \
        / math.sqrt(constants.e * constants.amu)
