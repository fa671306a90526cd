"""Exploration bookkeeping: rcount files, mechanism import, level setup.

Capability parity with Julia reference src/exploration/explore_utils.jl:
persistent reaction counters (explore_utils.jl:10-23), inert-species files
(35-46), CDE-run import into the CRN (65-105), full directory-tree
re-import (120-168), incomplete-run cleanup (182-210), level setup with
same-species + cross-species subspaces (224-263), seed file round trips
(273-311), and kinetics-gated seed selection for the next level (338-410).
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..core.network import RxData, SpeciesData, init_network
from ..utils.logging import flush_log, logger
from .cde import ingest_cde_run
from .location import ExploreLoc
from .molecule_system import system_from_mols


def make_rcount(path: str) -> int:
    """Read (or initialise to zero) a persistent reaction counter file."""
    if os.path.isfile(path):
        with open(path) as fh:
            return int(fh.readline())
    with open(path, "w") as fh:
        fh.write("00000")
    return 0


def make_inert_file(directory: str, inert_species: list[str]) -> None:
    if not inert_species:
        return
    with open(os.path.join(directory, "inert.in"), "w") as fh:
        for spec in inert_species:
            fh.write(f"{spec}\n")


def import_mechanism(loc: ExploreLoc, rcount: int, max_molecularity: int = 2,
                     duplicate_reverse: bool = True, unique_rxns: bool = True
                     ) -> tuple[SpeciesData, RxData]:
    """New (sd, rd) from one CDE run (explore_utils.jl:65-86)."""
    sd, rd = init_network()
    import_mechanism_inplace(sd, rd, loc, rcount,
                             max_molecularity=max_molecularity,
                             duplicate_reverse=duplicate_reverse,
                             unique_rxns=unique_rxns)
    return sd, rd


def import_mechanism_inplace(sd: SpeciesData, rd: RxData, loc: ExploreLoc,
                             rcount: int, max_molecularity: int = 2,
                             duplicate_reverse: bool = True,
                             unique_rxns: bool = True) -> None:
    """Extend (sd, rd) with one CDE run's reactions (explore_utils.jl:88-105)."""
    rdir = loc.path()
    (rsmis, rxyzs, rsys, psmis, pxyzs, psys, dHs) = ingest_cde_run(
        rdir, rcount, duplicate_reverse=duplicate_reverse)
    for smi_list, xyz_list in ((rsmis, rxyzs), (psmis, pxyzs)):
        for smis, xyzs in zip(smi_list, xyz_list):
            for smi, xyz in zip(smis, xyzs):
                sd.push_unique(smi, xyz, loc.level)
    rd.push(sd, rsmis, psmis, rsys, psys, dHs, loc.level,
            unique_rxns=unique_rxns, max_molecularity=max_molecularity)


def import_network(rdir_head: str) -> tuple[SpeciesData, RxData]:
    """Re-import a whole level tree (explore_utils.jl:120-168)."""
    logger.info("Importing all reactions in level tree under %s", rdir_head)
    flush_log()
    level_dirs = sorted(d for d in os.listdir(rdir_head)
                        if d.startswith("level_"))
    if not level_dirs:
        raise RuntimeError("No network levels found in rdir_head.")

    inert_file = os.path.join(rdir_head, "inert.in")
    inert_species = []
    if os.path.isfile(inert_file):
        with open(inert_file) as fh:
            inert_species = [ln.strip() for ln in fh if ln.strip()]

    sd, rd = init_network()
    for spec in inert_species:
        try:
            from ..chem import frame_from_smiles
            xyz = frame_from_smiles(spec)
        except Exception:
            xyz = None
        sd.push_unique(spec, xyz, 0)

    loc = ExploreLoc(rdir_head, 1, 1)
    for _ in level_dirs:
        loc.reset_subspace()
        lv_path = loc.path(to_level=True)
        ss_dirs = sorted(d for d in os.listdir(lv_path)
                         if d.startswith("subspace_"))
        for _ in ss_dirs:
            rcount = make_rcount(os.path.join(loc.path(), "rcount"))
            for reac in range(1, rcount + 1):
                import_mechanism_inplace(sd, rd, loc, reac)
            loc.inc_subspace()
        loc.inc_level()

    logger.info("Finished network import.")
    logger.info("Network contains %d species over %d reactions, explored "
                "over %d levels.", sd.n, rd.nr, len(level_dirs))
    flush_log()
    return sd, rd


def cleanup_network(rdir_head: str) -> int:
    """Remove CDE run dirs numbered above their subspace's rcount
    (explore_utils.jl:182-210)."""
    level_dirs = sorted(d for d in os.listdir(rdir_head)
                        if d.startswith("level_")) if os.path.isdir(rdir_head) else []
    removed = 0
    for lv in level_dirs:
        lv_dir = os.path.join(rdir_head, lv)
        for ss in sorted(d for d in os.listdir(lv_dir)
                         if d.startswith("subspace_")):
            ss_dir = os.path.join(lv_dir, ss)
            reac_dirs = sorted(d for d in os.listdir(ss_dir)
                               if d.startswith("reac_"))
            rcount = make_rcount(os.path.join(ss_dir, "rcount"))
            for rxn_dir in reac_dirs[rcount:]:
                shutil.rmtree(os.path.join(ss_dir, rxn_dir))
                removed += 1
    logger.debug("%d incomplete CDE runs removed.", removed)
    return removed


def setup_level(loc: ExploreLoc, sd: SpeciesData, seeds: list[str]) -> None:
    """Write seeds.in + per-subspace seeds.xyz (explore_utils.jl:224-263).

    One subspace per seed (same-species pair system) plus one cross-species
    subspace when there are multiple seeds.
    """
    lvdir = loc.path(to_level=True)
    if os.path.isdir(lvdir):
        if os.path.isfile(os.path.join(lvdir, "seeds.in")):
            logger.info("Level has been previously set up.")
            return
    else:
        os.makedirs(lvdir)

    logger.info("Setting up level directory tree in %s", lvdir)
    with open(os.path.join(lvdir, "seeds.in"), "w") as fh:
        fh.write(f"{len(seeds)}\n")
        fh.write("SID   SMILES\n")
        for sid, smi in enumerate(seeds, start=1):
            fh.write(f"{sid}    {smi}\n")

    for i, smi in enumerate(seeds, start=1):
        ssdir = os.path.join(lvdir, f"subspace_{i:03d}")
        os.makedirs(ssdir, exist_ok=True)
        xyz = sd.xyz[sd.toInt[smi]]
        system_from_mols([xyz, xyz],
                         saveto=os.path.join(ssdir, "seeds.xyz"))
    if len(seeds) > 1:
        ssdir = os.path.join(lvdir, f"subspace_{len(seeds) + 1:03d}")
        os.makedirs(ssdir, exist_ok=True)
        mols = [sd.xyz[sd.toInt[smi]] for smi in seeds]
        system_from_mols(mols, saveto=os.path.join(ssdir, "seeds.xyz"))


def load_current_seeds(loc: ExploreLoc) -> list[str]:
    """Seeds of the current level from seeds.in (explore_utils.jl:285-311)."""
    in_path = os.path.join(loc.path(to_level=True), "seeds.in")
    if not os.path.isfile(in_path):
        raise FileNotFoundError(f"Missing seeds.in file in level {loc.level}!")
    with open(in_path) as fh:
        lines = fh.read().splitlines()
    n_seeds = int(lines[0])
    seeds = [ln.split()[1] for ln in lines[2:] if ln.strip()]
    if len(seeds) != n_seeds:
        raise RuntimeError(f"Error parsing seeds.in file for level {loc.level}.")
    return seeds


def load_past_seeds(loc: ExploreLoc) -> list[str]:
    """All seeds of previous levels (explore_utils.jl:273-281)."""
    past = []
    for lv in range(1, loc.level):
        past += load_current_seeds(ExploreLoc(loc.rdir_head, lv, 1))
    return past


def identify_next_seeds(sol, sd: SpeciesData, seed_conc: float | None = None,
                        elim_small_na: int = 0, ignore: list[str] | None = None,
                        saveto: str | None = None) -> list[str]:
    """Species whose max concentration reaches ``seed_conc`` become next
    seeds (explore_utils.jl:338-410); on device this is one max-reduce over
    the solution tensor.

    ``sol`` may be a single :class:`ODESolution` (u: (T, ns)) or an
    :class:`EnsembleSolution` (u: (B, T, ns)) — for a batched condition
    sweep the gate takes the max concentration over members AND time, so
    a species that matters under ANY swept condition seeds the next
    level."""
    ignore = set(ignore or [])
    umat = np.asarray(sol.u)
    max_concs = umat.reshape(-1, umat.shape[-1]).max(axis=0)
    next_seeds, next_concs = [], []
    for sid in range(sd.n):
        smi = sd.toStr[sid]
        if smi in ignore:
            continue
        if seed_conc is not None and max_concs[sid] < seed_conc:
            continue
        if elim_small_na > 0:
            frame = sd.xyz.get(sid)
            na = frame["N_atoms"] if frame else 0
            if na < elim_small_na:
                continue
        next_seeds.append(smi)
        next_concs.append(float(max_concs[sid]))

    if saveto and next_seeds:
        pad = max(len(s) for s in next_seeds)
        with open(saveto, "w") as fh:
            fh.write(f"{len(next_seeds)}\n")
            fh.write(f"SID   {'SMILES'.ljust(pad)}   Max. Conc.\n")
            for sid, (smi, conc) in enumerate(zip(next_seeds, next_concs), 1):
                fh.write(f"{str(sid).ljust(5)} {smi.ljust(pad)}   {conc}\n")
    return next_seeds
