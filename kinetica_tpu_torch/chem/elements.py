"""Element data for the chem-lite backend.

Atomic masses (IUPAC 2021 standard weights), single-bond covalent radii
(Cordero et al. 2008), van der Waals radii (Bondi 1964 / Alvarez 2013) and
default valences for organic-range elements. Capability parity target: the
reference gets these through OpenBabel (molwt, vdW radii —
src/openbabel/properties.jl) and its connectivity perception.
"""
from __future__ import annotations

# symbol: (Z, mass/amu, covalent radius/Å, vdW radius/Å, default valences)
ELEMENTS: dict[str, tuple[int, float, float, float, tuple[int, ...]]] = {
    "H":  (1, 1.008, 0.31, 1.20, (1,)),
    "He": (2, 4.0026, 0.28, 1.40, (0,)),
    "Li": (3, 6.94, 1.28, 1.82, (1,)),
    "Be": (4, 9.0122, 0.96, 1.53, (2,)),
    "B":  (5, 10.81, 0.84, 1.92, (3,)),
    "C":  (6, 12.011, 0.76, 1.70, (4,)),
    "N":  (7, 14.007, 0.71, 1.55, (3,)),
    "O":  (8, 15.999, 0.66, 1.52, (2,)),
    "F":  (9, 18.998, 0.57, 1.47, (1,)),
    "Ne": (10, 20.180, 0.58, 1.54, (0,)),
    "Na": (11, 22.990, 1.66, 2.27, (1,)),
    "Mg": (12, 24.305, 1.41, 1.73, (2,)),
    "Al": (13, 26.982, 1.21, 1.84, (3,)),
    "Si": (14, 28.085, 1.11, 2.10, (4,)),
    "P":  (15, 30.974, 1.07, 1.80, (3, 5)),
    "S":  (16, 32.06, 1.05, 1.80, (2, 4, 6)),
    "Cl": (17, 35.45, 1.02, 1.75, (1,)),
    "Ar": (18, 39.948, 1.06, 1.88, (0,)),
    "K":  (19, 39.098, 2.03, 2.75, (1,)),
    "Ca": (20, 40.078, 1.76, 2.31, (2,)),
    "Br": (35, 79.904, 1.20, 1.85, (1,)),
    "I":  (53, 126.90, 1.39, 1.98, (1,)),
    "Xe": (54, 131.29, 1.40, 2.16, (0,)),
}

SYMBOLS = list(ELEMENTS)
Z_TO_SYMBOL = {v[0]: k for k, v in ELEMENTS.items()}

# SMILES "organic subset" — writable without brackets when standard-valence
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}


def atomic_number(sym: str) -> int:
    return ELEMENTS[sym][0]


def atomic_mass(sym: str) -> float:
    return ELEMENTS[sym][1]


def covalent_radius(sym: str) -> float:
    return ELEMENTS[sym][2]


def vdw_radius(sym: str) -> float:
    return ELEMENTS[sym][3]


def default_valences(sym: str) -> tuple[int, ...]:
    return ELEMENTS[sym][4]
