"""OpenBabel-backed system ingest — the reference's perception pipeline.

Implements Julia reference src/openbabel/conversion.jl:12-33: an XYZ
system string is read by Pybel, separated into connected fragments, each
emitted as canonical SMILES + an ExtXYZ frame. When the OBCanonicalRadicals
package ("obcr") is importable, radical fragments are repaired through it
exactly as the reference does; otherwise radical SMILES pass through
OpenBabel's own perception (logged once).

Only imported when OpenBabel is available (chem.backends.HAS_OPENBABEL);
the public entry point lives in chem.conversion and dispatches here.
"""
from __future__ import annotations

from ..utils.logging import logger
from .xyz import Frame, xyz_to_frame

try:  # OBCanonicalRadicals is a separate, optional package
    import obcr  # type: ignore

    HAS_OBCR = True
except Exception:  # pragma: no cover
    obcr = None
    HAS_OBCR = False

_warned_no_obcr = False


def ingest_xyz_system(xyz_str: str, fix_radicals: bool = True
                      ) -> tuple[list[str], list[Frame]]:
    """Split an XYZ string into per-fragment (canonical SMILES, frame)."""
    global _warned_no_obcr
    from openbabel import pybel

    pbmol = pybel.readstring("xyz", xyz_str)
    fragments = [pybel.Molecule(obmol) for obmol in pbmol.OBMol.Separate()]
    smi_list = [frag.write("can").strip("\n\t ") for frag in fragments]

    if fix_radicals:
        if HAS_OBCR:
            for i, smi in enumerate(smi_list):
                if obcr.is_radical(smi):
                    fragments[i] = obcr.fix_radicals(fragments[i])
                    fragments[i].addh()
                    smi_list[i] = fragments[i].write("can").strip("\n\t ")
        elif not _warned_no_obcr:
            logger.warning(
                "OBCanonicalRadicals (obcr) is not importable: radical "
                "SMILES keep OpenBabel's raw perception "
                "(conversion.jl:19-27 fixup skipped).")
            _warned_no_obcr = True

    frames = [xyz_to_frame(frag.write("xyz")) for frag in fragments]
    return smi_list, frames


def canonical_smiles_ob(smiles: str) -> str:
    """Canonical (OpenBabel "can" format) SMILES round-trip."""
    from openbabel import pybel
    return pybel.readstring("smi", smiles).write("can").strip("\n\t ")
