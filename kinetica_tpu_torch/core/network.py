"""CRN data model: species and reaction stores.

Same capability as the reference's network layer
(Julia reference src/exploration/network.jl):

* ``SpeciesData`` — bidirectional SMILES <-> integer-ID map with per-species
  geometry frames, discovery level and an open property cache
  (network.jl:1-190).
* ``RxData`` — reactions as unique species-ID lists + stoichiometry vectors,
  atom-mapped reaction SMILES, reaction enthalpies and an order-stable
  reaction hash; the constructor/push dedup by hash and reject
  conformational no-ops and reactions above ``max_molecularity``
  (network.jl:193-426).
* hash helpers, ``splice``, ``format_rxn`` (network.jl:433-562).

Hashes here are sha256 over the sorted reactant + product canonical SMILES
(the reference uses StableHashTraits ``stable_hash`` v4 of the same list,
network.jl:284 — any order-stable digest is equivalent in function).

The numeric, TPU-facing view of this data (padded index/stoichiometry
matrices) is built by :mod:`kinetica_tpu_torch.models.mass_action`.
"""
from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Any

from ..utils.logging import logger

Frame = dict[str, Any]  # ExtXYZ-style frame: {"N_atoms", "info", "arrays"}


def stable_species_hash(all_reacs: list[str], all_prods: list[str]) -> bytes:
    """Order-stable reaction hash over sorted reactant/product SMILES."""
    payload = "\x1f".join(sorted(all_reacs)) + "\x1e" + "\x1f".join(sorted(all_prods))
    return hashlib.sha256(payload.encode()).digest()


class SpeciesData:
    """Bidirectional SMILES <-> integer-ID store (0-based IDs).

    Fields mirror the reference (network.jl:1-8): ``toInt``, ``toStr``,
    ``n``, ``xyz``, ``level_found`` and an open ``cache`` dict for computed
    per-species properties (mult, charge, weights, radii, vib energies, ...).
    """

    def __init__(self, smi_list=None, xyz_list=None, level: int = 1,
                 unique_species: bool = True):
        self.toInt: dict[str, int] = {}
        self.toStr: dict[int, str] = {}
        self.n: int = 0
        self.xyz: dict[int, Frame] = {}
        self.level_found: dict[int, int] = {}
        self.cache: dict[Any, Any] = {}
        if smi_list is not None:
            xyz_list = xyz_list if xyz_list is not None else [None] * len(smi_list)
            for smi, xyz in zip(smi_list, xyz_list):
                if unique_species:
                    self.push_unique(smi, xyz, level)
                else:
                    self.push(smi, xyz, level)

    @classmethod
    def from_xyz_file(cls, xyz_file: str, level: int = 1, unique_species: bool = True,
                      fix_radicals: bool = True) -> "SpeciesData":
        """Build from a (possibly multi-molecule) XYZ file (network.jl:74-79).

        The chemistry layer (``kinetica_tpu.chem``) is not ported yet."""
        raise NotImplementedError("XYZ ingestion needs the chemistry layer, "
                                  "which kinetica_tpu_torch does not port yet")

    def push(self, smi: str, xyz: Frame | None = None, level: int = 1) -> int:
        """Unconditionally add a species; returns its new ID."""
        sid = self.n
        self.toInt[smi] = sid
        self.toStr[sid] = smi
        self.xyz[sid] = xyz
        self.level_found[sid] = level
        self.n += 1
        return sid

    def push_unique(self, smi: str, xyz: Frame | None = None, level: int = 1) -> int:
        """Add a species only if not already present; returns its ID."""
        if smi in self.toInt:
            return self.toInt[smi]
        return self.push(smi, xyz, level)

    def push_xyz_file(self, xyz_file: str, level: int = 1, unique: bool = True,
                      fix_radicals: bool = True) -> None:
        raise NotImplementedError("XYZ ingestion needs the chemistry layer, "
                                  "which kinetica_tpu_torch does not port yet")

    def __contains__(self, smi: str) -> bool:
        return smi in self.toInt

    def __len__(self) -> int:
        return self.n

    def copy(self) -> "SpeciesData":
        import copy as _copy
        return _copy.deepcopy(self)


@dataclass
class RxData:
    """Reaction store (reference network.jl:193-203).

    Per-reaction parallel lists; ``id_reacs[i]``/``id_prods[i]`` hold the
    *unique* species IDs and ``stoic_reacs[i]``/``stoic_prods[i]`` their
    counts. ``mapped_rxns`` holds atom-mapped reaction SMILES where the
    chemistry backend can produce them ("" otherwise).
    """
    nr: int = 0
    mapped_rxns: list[str] = field(default_factory=list)
    id_reacs: list[list[int]] = field(default_factory=list)
    id_prods: list[list[int]] = field(default_factory=list)
    stoic_reacs: list[list[int]] = field(default_factory=list)
    stoic_prods: list[list[int]] = field(default_factory=list)
    dH: list[float] = field(default_factory=list)
    rhash: list[bytes] = field(default_factory=list)
    level_found: list[int] = field(default_factory=list)

    @classmethod
    def from_reactions(cls, sd: SpeciesData, reacs: list[list[str]],
                       prods: list[list[str]], rsys=None, psys=None,
                       dH=None, level: int = 1, unique_rxns: bool = True,
                       max_molecularity: int = 2) -> "RxData":
        rd = cls()
        rd.push(sd, reacs, prods, rsys, psys, dH, level,
                unique_rxns=unique_rxns, max_molecularity=max_molecularity)
        return rd

    def push(self, sd: SpeciesData, reacs: list[list[str]], prods: list[list[str]],
             rsys=None, psys=None, dH=None, level: int = 1,
             unique_rxns: bool = True, max_molecularity: int = 2) -> None:
        """Append reactions given raw (duplicated) SMILES lists.

        Dedups by hash, rejects conformational no-ops and molecularity >
        ``max_molecularity`` on either side, determines stoichiometry, and
        builds atom-mapped reaction SMILES when geometry frames
        (``rsys``/``psys``) and a capable chemistry backend are available.
        Mirrors reference network.jl:356-426.
        """
        n_in = len(reacs)
        rsys = rsys if rsys is not None else [None] * n_in
        psys = psys if psys is not None else [None] * n_in
        dH = dH if dH is not None else [0.0] * n_in
        inv_counter = 0
        dup_counter = 0
        for i in range(n_in):
            reac_counter = Counter(reacs[i])
            prod_counter = Counter(prods[i])

            # Conformational no-ops are invalid (network.jl:263).
            if reac_counter == prod_counter:
                inv_counter += 1
                continue
            # Molecularity limit applies to both sides (network.jl:269-279).
            if (len(reac_counter) > max_molecularity or len(prod_counter) > max_molecularity
                    or sum(reac_counter.values()) > max_molecularity
                    or sum(prod_counter.values()) > max_molecularity):
                inv_counter += 1
                continue

            all_reacs = sorted(reacs[i])
            all_prods = sorted(prods[i])
            h = stable_species_hash(all_reacs, all_prods)
            if unique_rxns and h in self.rhash:
                dup_counter += 1
                continue

            mapped_rxn = ""
            if rsys[i] is not None and psys[i] is not None:
                try:
                    from ..chem import atom_map_smiles  # not ported yet
                    mapped_reacs = atom_map_smiles(rsys[i], ".".join(all_reacs))
                    mapped_prods = atom_map_smiles(psys[i], ".".join(all_prods))
                    mapped_rxn = f"{mapped_reacs}>>{mapped_prods}"
                except Exception as exc:  # backend-optional feature
                    logger.debug("atom mapping unavailable: %s", exc)

            unique_reacs = list(dict.fromkeys(all_reacs))
            unique_prods = list(dict.fromkeys(all_prods))
            for spec in unique_reacs + unique_prods:
                if spec not in sd.toInt:
                    raise KeyError(f"Species {spec} not present in SpeciesData")

            self.nr += 1
            self.mapped_rxns.append(mapped_rxn)
            self.id_reacs.append([sd.toInt[s] for s in unique_reacs])
            self.id_prods.append([sd.toInt[s] for s in unique_prods])
            self.stoic_reacs.append([reac_counter[s] for s in unique_reacs])
            self.stoic_prods.append([prod_counter[s] for s in unique_prods])
            self.dH.append(float(dH[i]))
            self.rhash.append(h)
            self.level_found.append(level)
        logger.debug(" - %d duplicate and %d invalid reactions found.",
                     dup_counter, inv_counter)

    def push_rxn(self, sd: SpeciesData, reac_smis: list[str], prod_smis: list[str],
                 dH: float = 0.0, level: int = 1, unique_rxns: bool = True,
                 max_molecularity: int = 2) -> None:
        """Convenience: add one reaction from already-duplicated SMILES lists."""
        self.push(sd, [reac_smis], [prod_smis], dH=[dH], level=level,
                  unique_rxns=unique_rxns, max_molecularity=max_molecularity)

    def get_rhash(self, sd: SpeciesData, rid: int) -> bytes:
        """Recompute the forward hash of reaction ``rid`` (network.jl:433)."""
        reacs = sorted(
            sd.toStr[sid]
            for j, sid in enumerate(self.id_reacs[rid])
            for _ in range(self.stoic_reacs[rid][j]))
        prods = sorted(
            sd.toStr[sid]
            for j, sid in enumerate(self.id_prods[rid])
            for _ in range(self.stoic_prods[rid][j]))
        return stable_species_hash(reacs, prods)

    def get_reverse_rhash(self, sd: SpeciesData, rid: int) -> bytes:
        """Hash of the reverse of reaction ``rid`` (network.jl:455-481)."""
        reacs = sorted(
            sd.toStr[sid]
            for j, sid in enumerate(self.id_reacs[rid])
            for _ in range(self.stoic_reacs[rid][j]))
        prods = sorted(
            sd.toStr[sid]
            for j, sid in enumerate(self.id_prods[rid])
            for _ in range(self.stoic_prods[rid][j]))
        assert self.rhash[rid] == stable_species_hash(reacs, prods)
        return stable_species_hash(prods, reacs)

    def splice(self, rids) -> None:
        """Remove reactions at indices ``rids`` (network.jl:514-529)."""
        rids = sorted(set(int(r) for r in rids))
        if not rids:
            return
        keep = [i for i in range(self.nr) if i not in set(rids)]
        for name in ("mapped_rxns", "id_reacs", "id_prods", "stoic_reacs",
                     "stoic_prods", "dH", "rhash", "level_found"):
            vals = getattr(self, name)
            setattr(self, name, [vals[i] for i in keep])
        self.nr = len(keep)

    def copy(self) -> "RxData":
        import copy as _copy
        return _copy.deepcopy(self)

    def __len__(self) -> int:
        return self.nr


def init_network() -> tuple[SpeciesData, RxData]:
    """Typed empty (sd, rd) pair (reference network.jl:491-506)."""
    return SpeciesData(), RxData()


def format_rxn(sd: SpeciesData, rd: RxData, rid: int, display_level: bool = False) -> str:
    """Human-readable reaction string (reference network.jl:540-556)."""
    reac_strs = [
        f"{n} {sd.toStr[sid]}" if n > 1 else sd.toStr[sid]
        for n, sid in zip(rd.stoic_reacs[rid], rd.id_reacs[rid])]
    prod_strs = [
        f"{n} {sd.toStr[sid]}" if n > 1 else sd.toStr[sid]
        for n, sid in zip(rd.stoic_prods[rid], rd.id_prods[rid])]
    rxn_str = " + ".join(reac_strs) + " --> " + " + ".join(prod_strs)
    if display_level:
        rxn_str = f"L{rd.level_found[rid]}: " + rxn_str
    return rxn_str


def print_rxn(sd: SpeciesData, rd: RxData, rid: int, display_level: bool = False) -> None:
    print(format_rxn(sd, rd, rid, display_level=display_level))
