"""Exploration drivers: Direct and Iterative CRN exploration.

Capability parity with Julia reference src/exploration/methods.jl:

* :class:`DirectExplore` — single-level exploration of all reactions within
  ``cde.radius`` of the starting reactants (methods.jl:18-25, 85-147),
* :class:`IterativeExplore` — level loop: setup_level -> explore each
  subspace to convergence -> ``solve_network`` on device -> gate the next
  level's seeds on the batched kinetic solution -> converge when the seed
  set is stable for ``seed_convergence_threshold`` levels
  (methods.jl:49-61, 150-266),
* :func:`explore_subspace` — the inner CDE loop with the
  no-new-reactions convergence criterion and failure cycling
  (methods.jl:281-384).

Both drivers are restartable at level and subspace granularity from the
filesystem (rcount / isconv / seeds.in markers), exactly as the reference.
Counterpart of ``kinetica_tpu/exploration/methods.py``: the per-level
kinetic solve runs on ``device`` (the card unless the caller asks for the
CPU) through :func:`kinetica_tpu_torch.solving.methods.solve_network`, or
through :class:`kinetica_tpu_torch.parallel.batching.EnsembleProblem` for
a condition sweep.
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field

import numpy as np

from ..chem.conversion import frame_from_smiles
from ..core.network import RxData, SpeciesData, init_network
from ..device import DEFAULT_DEVICE, resolve_device
from ..solving.methods import AbstractODESolveMethod, solve_network
from ..solving.solutions import RETCODE_SUCCESS
from ..utils.logging import flush_log, logger
from .cde import CDE
from .explore_utils import (cleanup_network, identify_next_seeds,
                            import_mechanism_inplace, import_network,
                            load_current_seeds, load_past_seeds,
                            make_inert_file, make_rcount, setup_level)
from .location import ExploreLoc, find_current_loc


class AbstractExploreMethod:
    pass


@dataclass
class DirectExplore(AbstractExploreMethod):
    rdir_head: str
    reac_smiles: list[str]
    cde: CDE
    maxiters: int = 1000
    rxn_convergence_threshold: int = 5
    modify_network_on_solve: bool = True


@dataclass
class IterativeExplore(AbstractExploreMethod):
    rdir_head: str
    reac_smiles: list[str]
    cde: CDE
    maxiters: int = 1000
    rxn_convergence_threshold: int = 5
    seed_convergence_threshold: int = 3
    seed_conc: float = 0.05
    n_undirected_levels: int = 0
    independent_blacklist: list[str] = field(default_factory=list)
    inert_species: list[str] = field(default_factory=list)
    modify_network_on_solve: bool = True
    # Batched kinetics-in-the-loop gating (BASELINE config 5; no
    # reference equivalent — methods.jl gates each level on ONE solve):
    # when set, every level's kinetic simulation is a batched ensemble
    # sweep over these ConditionSets (one EnsembleProblem solve on the
    # device) and next-level seeds are selected from the max
    # concentration over members and time, so species that matter under
    # ANY swept condition are explored. The per-level checkpoint stores
    # member 0's trajectory. The network is never modified in place on
    # this path (EnsembleProblem filters on copies).
    solve_conditions_list: list | None = None
    # Hard level budget (no reference equivalent): stop after this many
    # levels even if seeds have not converged — bounds wall-clock on
    # open-ended chemistries. None = run to seed convergence.
    max_levels: int | None = None
    # Optional phase-timing collector (BASELINE config 5 benching): when
    # a list is supplied, one dict per level is appended with the wall
    # time of each phase — sampling/ingest ("explore_s"), the batched
    # device solve gate ("solve_s"), seed selection ("seeds_s") — plus
    # network size, so the host<->device interleave cost of the product
    # loop (methods.jl:150-266, solve gate at :221) is measurable. The
    # port adds the gate's most steps over its lanes ("n_steps_max") and
    # its device-to-host reads ("host_syncs").
    timings: list | None = None
    # Optional gate record (the port's): when a list is supplied, one
    # dict per level is appended with the gate's solution ("sol": the
    # EnsembleSolution of a sweep, else the ODESolution), the network it
    # solved ("sd", "rd") and the next level's seeds ("next_seeds").
    gate_log: list | None = None


def _mark_converged(loc: ExploreLoc) -> None:
    os.makedirs(loc.path(), exist_ok=True)
    with open(os.path.join(loc.path(), "isconv"), "w") as fh:
        fh.write("true")


def explore_subspace(sd: SpeciesData, rd: RxData, loc: ExploreLoc,
                     exploremethod: AbstractExploreMethod) -> None:
    """Inner CDE loop for one subspace (methods.jl:281-384)."""
    logger.info("--------------------------")
    logger.info("ENTERING SUBSPACE %d", loc.subspace)
    logger.info("--------------------------")
    flush_log()

    cpath = os.path.join(loc.path(), "isconv")
    if os.path.isfile(cpath):
        logger.info("Subspace is already converged.")
        return

    cde = exploremethod.cde
    cde.rdir = loc.path()
    cde.init_xyz = os.path.join(loc.path(), "seeds.xyz")
    rcount = make_rcount(os.path.join(loc.path(), "rcount"))

    counter = 0
    no_new_reacs_iters = 0
    logger.info(" - %s iterations.", "Starting" if rcount == 0 else "Continuing")
    flush_log()

    while True:
        if counter > exploremethod.maxiters:
            raise RuntimeError(
                f"{exploremethod.maxiters} iterations exceeded, exiting loop")
        counter += 1
        logger.info("--- ITERATION %d ---", counter)
        rcount += 1

        if cde.parallel_runs > 1:
            rrange = range(rcount, rcount + cde.parallel_runs)
            rcountend = cde(rrange)
            if rcountend < rrange.start:
                logger.warning("Sampling failed, cycling...")
                flush_log()
                rcount -= 1
                continue
            imported = range(rrange.start, rcountend + 1)
        else:
            if not cde(rcount):
                logger.warning("Sampling failed, cycling...")
                flush_log()
                rcount -= 1
                continue
            imported = range(rcount, rcount + 1)

        logger.info(" - Importing generated reactions.")
        n_reacs_prev = rd.nr
        for rc in imported:
            import_mechanism_inplace(sd, rd, loc, rc)
        rcount = imported.stop - 1
        logger.info("   - Reaction network now contains %d reactions over %d "
                    "unique fragments.", rd.nr, sd.n)
        flush_log()

        if n_reacs_prev != rd.nr:
            no_new_reacs_iters = 0
            logger.info(" - New reactions discovered, reaction network not "
                        "converged.")
            continue

        no_new_reacs_iters += 1
        logger.info(" - No new reactions discovered for %d/%d iterations.",
                    no_new_reacs_iters, exploremethod.rxn_convergence_threshold)
        if no_new_reacs_iters >= exploremethod.rxn_convergence_threshold:
            logger.info("   - Species subspace converged!")
            _mark_converged(loc)
            return


def explore_network(exploremethod: AbstractExploreMethod,
                    solvemethod: AbstractODESolveMethod,
                    savedir: str | None = None, device=DEFAULT_DEVICE):
    """Run a CRN exploration + kinetic simulation (methods.jl:85-266);
    every kinetic solve runs on ``device``."""
    device = resolve_device(device)
    if isinstance(exploremethod, DirectExplore):
        return _explore_direct(exploremethod, solvemethod, savedir, device)
    if isinstance(exploremethod, IterativeExplore):
        return _explore_iterative(exploremethod, solvemethod, savedir, device)
    raise TypeError(f"Unknown explore method {type(exploremethod)}")


def _save_checkpoint(res, savedir: str | None, name: str) -> None:
    if savedir is None:
        return
    from ..analysis.io import save_output
    os.makedirs(savedir, exist_ok=True)
    saveto = os.path.join(savedir, name)
    save_output(res, saveto)
    logger.info("Network saved to %s", saveto)


def _explore_direct(exploremethod: DirectExplore,
                    solvemethod: AbstractODESolveMethod,
                    savedir: str | None, device):
    logger.info("#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#")
    logger.info("Kinetica Direct CRN Exploration")
    logger.info("#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#")
    flush_log()

    os.makedirs(exploremethod.rdir_head, exist_ok=True)
    loc = find_current_loc(exploremethod.rdir_head)
    if loc.level > 1:
        raise RuntimeError("Current CRN level is greater than 1. Are you "
                           "trying to continue an iterative exploration?")
    seeds = exploremethod.reac_smiles
    if loc.level == 0:
        sd, rd = init_network()
        for rsmi in dict.fromkeys(seeds):
            sd.push_unique(rsmi, frame_from_smiles(
                rsmi, seed=random.randint(1, 999999999)))
        loc.inc_level()
        setup_level(loc, sd, seeds)
        logger.info("Starting breakdown generation within a radius of %d "
                    "reactions.", exploremethod.cde.radius)
    else:
        cleanup_network(loc.rdir_head)
        sd, rd = import_network(loc.rdir_head)
        logger.info("Continuing breakdown generation within a radius of %d "
                    "reactions.", exploremethod.cde.radius)

    n_seeds = len(seeds)
    n_subspaces = 1 if n_seeds == 1 else n_seeds + 1
    explored: list[str] = []
    while loc.subspace < n_subspaces:
        spec = seeds[loc.subspace - 1]
        if spec in explored:
            _mark_converged(loc)
            logger.info("Same-species reactions between %s already covered; "
                        "skipping subspace %d", spec, loc.subspace)
        else:
            explore_subspace(sd, rd, loc, exploremethod)
            explored.append(spec)
        loc.inc_subspace()
    explore_subspace(sd, rd, loc, exploremethod)

    logger.info("Exploration complete, running kinetic simulation of current "
                "network.")
    flush_log()
    res = solve_network(solvemethod, sd, rd,
                        copy_network=not exploremethod.modify_network_on_solve,
                        device=device)
    logger.info("Direct network exploration complete.")
    _save_checkpoint(res, savedir, "direct_network_final.npz")
    return res


def _explore_iterative(exploremethod: IterativeExplore,
                       solvemethod: AbstractODESolveMethod,
                       savedir: str | None, device):
    from ..ops import host_sync

    logger.info("#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-")
    logger.info("Kinetica Iterative CRN Exploration")
    logger.info("#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-#-")
    flush_log()

    os.makedirs(exploremethod.rdir_head, exist_ok=True)
    loc = find_current_loc(exploremethod.rdir_head)
    if loc.level == 0:
        sd, rd = init_network()
        make_inert_file(exploremethod.rdir_head, exploremethod.inert_species)
        for rsmi in (list(exploremethod.reac_smiles)
                     + list(exploremethod.inert_species)):
            sd.push_unique(rsmi, frame_from_smiles(
                rsmi, seed=random.randint(1, 999999999)))
        explored_seeds: list[str] = []
        current_seeds = list(exploremethod.reac_smiles)
        loc.inc_level()
    else:
        cleanup_network(loc.rdir_head)
        sd, rd = import_network(loc.rdir_head)
        explored_seeds = load_past_seeds(loc)
        current_seeds = load_current_seeds(loc)

    convergence_count = 0
    res = None
    while True:
        logger.info("##########################")
        logger.info("ENTERING LEVEL %d", loc.level)
        logger.info("##########################")
        flush_log()

        t_level0 = time.perf_counter()
        setup_level(loc, sd, current_seeds)
        n_seeds = len(current_seeds)
        n_subspaces = 1 if n_seeds == 1 else n_seeds + 1

        while loc.subspace < n_subspaces:
            spec = current_seeds[loc.subspace - 1]
            if spec in explored_seeds:
                _mark_converged(loc)
                logger.info("Same-species reactions between %s already "
                            "covered; skipping subspace %d", spec, loc.subspace)
            elif spec in exploremethod.independent_blacklist:
                _mark_converged(loc)
                logger.info("Same-species reactions between %s prohibited by "
                            "blacklist; skipping subspace %d", spec, loc.subspace)
            else:
                explore_subspace(sd, rd, loc, exploremethod)
            loc.inc_subspace()
        explore_subspace(sd, rd, loc, exploremethod)

        logger.info("Exploration complete, running kinetic simulation of "
                    "current network.")
        flush_log()
        t_solve0 = time.perf_counter()
        syncs0 = host_sync.count
        conds_list = exploremethod.solve_conditions_list
        if conds_list:
            # batched condition-sweep gate (one batched device solve)
            from ..analysis.io import ODESolveOutput
            from ..parallel.batching import EnsembleProblem
            prob = EnsembleProblem(solvemethod, sd, rd, device=device)
            ens = prob.solve(conditions_list=list(conds_list))
            if not ens.success:
                raise RuntimeError(
                    f"Batched kinetic simulation of level {loc.level} network "
                    f"failed for {sum(rc != RETCODE_SUCCESS for rc in ens.retcodes)}"
                    f"/{ens.n_batch} members; refusing to select next-level "
                    "seeds from a failed sweep.")
            res = ODESolveOutput(solvemethod, ens[0], prob.sd, prob.rd)
            gate_sol = ens
            n_steps_max = int(np.max(ens.stats["n_steps"]))
        else:
            res = solve_network(
                solvemethod, sd, rd,
                copy_network=not exploremethod.modify_network_on_solve,
                device=device)
            gate_sol = res.sol
            n_steps_max = int(res.sol.stats["n_steps"])
            # Refuse to gate the next exploration level on a failed solve:
            # seeds picked from garbage concentrations silently poison
            # every subsequent level (solve_network's adaptive retry raises
            # on unrecoverable failures, but retcodes are re-checked here
            # so any future non-raising path cannot slip through).
            if res.sol.retcode != RETCODE_SUCCESS:
                raise RuntimeError(
                    f"Kinetic simulation of level {loc.level} network ended "
                    f"with retcode {res.sol.retcode!r}; refusing to select "
                    "next-level seeds from a failed solve.")
        t_solve1 = time.perf_counter()
        gate_syncs = host_sync.count - syncs0
        _save_checkpoint(res, savedir, f"level_network_1-{loc.level}.npz")

        explored_seeds += [s for s in current_seeds if s not in explored_seeds]
        seeds_out = (None if savedir is None
                     else os.path.join(savedir, f"seeds_level{loc.level}.out"))
        if loc.level <= exploremethod.n_undirected_levels:
            next_seeds = identify_next_seeds(
                gate_sol, res.sd, ignore=exploremethod.inert_species,
                saveto=seeds_out)
        else:
            next_seeds = identify_next_seeds(
                gate_sol, res.sd, exploremethod.seed_conc,
                ignore=exploremethod.inert_species, saveto=seeds_out)

        if exploremethod.timings is not None:
            t_end = time.perf_counter()
            exploremethod.timings.append({
                "level": loc.level,
                "explore_s": round(t_solve0 - t_level0, 4),
                "solve_s": round(t_solve1 - t_solve0, 4),
                "seeds_s": round(t_end - t_solve1, 4),
                "n_species": sd.n, "n_reactions": rd.nr,
                "batch": (len(conds_list) if conds_list else 1),
                "n_seeds_next": len(next_seeds),
                "n_steps_max": n_steps_max, "host_syncs": gate_syncs})
        if exploremethod.gate_log is not None:
            exploremethod.gate_log.append({
                "level": loc.level, "sol": gate_sol, "sd": res.sd,
                "rd": res.rd, "next_seeds": list(next_seeds)})

        if (exploremethod.max_levels is not None
                and loc.level >= exploremethod.max_levels):
            logger.info("LEVEL BUDGET (%d) REACHED — STOPPING ITERATIVE "
                        "EXPLORATION", exploremethod.max_levels)
            break

        if set(current_seeds) == set(next_seeds):
            convergence_count += 1
            if convergence_count >= exploremethod.seed_convergence_threshold:
                logger.info("NO NEW SEEDS FOUND FOR %d/%d LEVELS — ITERATIVE "
                            "EXPLORATION COMPLETE", convergence_count,
                            exploremethod.seed_convergence_threshold)
                break
            logger.info("No new seeds found for %d/%d levels; continuing.",
                        convergence_count,
                        exploremethod.seed_convergence_threshold)
        else:
            logger.info("New seeds found, continuing to next level.")
        loc.inc_level()
        loc.reset_subspace()
        current_seeds = list(next_seeds)
        flush_log()

    return res
