"""Chemistry backend detection.

The reference reaches RDKit/OpenBabel/ASE/autodE through a PythonCall
bridge (src/Kinetica.jl:34-105); this framework is Python-first, so those
layers are plain optional imports. When absent, the self-contained
chem-lite implementations (graphmol/conversion) carry the pipeline, and the
ASE-dependent TST calculator degrades to a clear error at construction.
"""
from __future__ import annotations

import importlib.util


def _has(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


HAS_RDKIT = _has("rdkit")
HAS_OPENBABEL = _has("openbabel")
HAS_ASE = _has("ase")
HAS_AUTODE = _has("autode")


def require(name: str, flag: bool, purpose: str) -> None:
    if not flag:
        raise ImportError(
            f"{name} is required for {purpose} but is not installed. "
            f"The chem-lite backend covers SMILES/geometry/bond perception; "
            f"{purpose} needs the real package.")
