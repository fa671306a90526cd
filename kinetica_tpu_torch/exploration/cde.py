"""CDE subprocess orchestration.

Same capability as the reference's CDE runner
(Julia reference src/exploration/cde.jl): template-directory staging, input
file preparation (nmcrxn/nrxn/ranseed appends, cde.jl:66-72), serial and
bounded-parallel execution, ``input.log`` ERROR scanning + output-file
existence checks (cde.jl:87-121), persistent ``rcount`` bookkeeping,
``allow_errors`` directory cleanup/renumbering (cde.jl:182-229), and
:func:`ingest_cde_run` which reads the 2-frame reaction trajectories,
splits them into fragment species, computes dH from frame energies, and
optionally appends all reverse reactions (cde.jl:258-316).

The CDE binary itself is external (Fortran, driving xTB); any executable
with the same file contract works — tests use a mock.
"""
from __future__ import annotations

import os
import random
import shutil
import subprocess
from dataclasses import dataclass, field

from ..chem import frame_to_xyz, ingest_xyz_system, read_xyz_file
from ..utils.logging import flush_log, logger
from .cde_utils import env_multithread, parallel_run


def _rxdir(rdir: str, rcount: int) -> str:
    return os.path.join(rdir, f"reac_{rcount:05d}")


@dataclass
class CDE:
    """CDE runner; call with an int (serial) or a range (parallel pool)."""
    template_dir: str
    env_threads: int = 1
    cde_exec: str = "cde"
    sampling_seed: int = 0
    radius: int = 50
    nrxn: int = 1
    parallel_runs: int = 1
    parallel_exes: int | None = None
    write_stdout: bool = True
    write_stderr: bool = False
    allow_errors: bool = False
    # managed by the exploration drivers:
    rdir: str = "CHANGEME"
    init_xyz: str = "seeds.xyz"

    def __post_init__(self):
        if self.parallel_exes is None:
            self.parallel_exes = self.parallel_runs

    # -- single run ---------------------------------------------------------
    def __call__(self, rcount):
        if isinstance(rcount, range):
            return self.run_range(rcount)
        return self.run_single(int(rcount))

    def _stage(self, rcount: int) -> str:
        rxdir = _rxdir(self.rdir, rcount)
        shutil.copytree(self.template_dir, rxdir)
        shutil.copy(self.init_xyz, os.path.join(rxdir, "Start.xyz"))
        seed = (random.randint(1, 100000) if self.sampling_seed == 0
                else self.sampling_seed + rcount)
        with open(os.path.join(rxdir, "input"), "a") as fh:
            fh.write(f"nmcrxn {self.nrxn}\n")
            fh.write(f"nrxn {self.radius}\n")
            fh.write(f"ranseed {seed}\n")
        return rxdir

    def _check(self, rxdir: str) -> bool:
        success = True
        log_path = os.path.join(rxdir, "input.log")
        if os.path.isfile(log_path):
            with open(log_path) as fh:
                for line in fh:
                    if "ERROR" in line:
                        logger.warning("Error in CDE run, check logs for more "
                                       "information (%s)", rxdir)
                        success = False
                        break
        if not os.path.exists(os.path.join(rxdir, "rxn_0001_step_0001.xyz")):
            logger.warning("Error in CDE run, no reaction steps found (%s)", rxdir)
            success = False
        return success

    def _write_rcount(self, value: int) -> None:
        with open(os.path.join(self.rdir, "rcount"), "w") as fh:
            fh.write(f"{value:05d}")

    def run_single(self, rcount: int) -> bool:
        logger.info("--- Reaction %d ---", rcount)
        logger.info(" - Starting new reaction mechanism generation.")
        flush_log()
        rxdir = self._stage(rcount)
        outfile = os.path.join(rxdir, "cde.out") if self.write_stdout else None
        errfile = os.path.join(rxdir, "cde.err") if self.write_stderr else None
        stdout = open(outfile, "w") if outfile else subprocess.DEVNULL
        stderr = open(errfile, "w") if errfile else subprocess.DEVNULL
        try:
            subprocess.run([self.cde_exec, "input"], cwd=rxdir,
                           env=env_multithread(self.env_threads),
                           stdout=stdout, stderr=stderr)
        finally:
            for fh in (stdout, stderr):
                if fh is not subprocess.DEVNULL:
                    fh.close()

        if self._check(rxdir):
            logger.info("   - Sampling completed successfully!")
            self._write_rcount(rcount)
            flush_log()
            return True
        if not self.allow_errors:
            raise RuntimeError("Forbidden error in CDE run, stopping exploration.")
        logger.info("   - Sampling failed, removing directory.")
        shutil.rmtree(rxdir)
        flush_log()
        return False

    # -- parallel pool ------------------------------------------------------
    def run_range(self, rcountrange: range) -> int:
        """Run several CDE samplings concurrently; returns the new rcount."""
        logger.info("--- Reactions %d - %d ---", rcountrange.start,
                    rcountrange.stop - 1)
        logger.info(" - Starting new reaction mechanism generation.")
        flush_log()
        rcs = list(rcountrange)
        rxdirs = [self._stage(rc) for rc in rcs]
        env = env_multithread(self.env_threads)
        cmds = []
        for rxdir in rxdirs:
            cmds.append({
                "args": [self.cde_exec, "input"], "cwd": rxdir, "env": env,
                "stdout": os.path.join(rxdir, "cde.out") if self.write_stdout else None,
                "stderr": os.path.join(rxdir, "cde.err") if self.write_stderr else None,
            })
        parallel_run(cmds, ntasks=self.parallel_exes)

        success = [self._check(rxdir) for rxdir in rxdirs]
        if all(success):
            logger.info("   - Sampling completed successfully!")
            self._write_rcount(rcs[-1])
            flush_log()
            return rcs[-1]
        if not self.allow_errors:
            raise RuntimeError("Forbidden error in at least one CDE run, "
                               "stopping exploration.")
        # remove failures and renumber survivors contiguously (cde.jl:213-229)
        for ok, rxdir in zip(success, rxdirs):
            if not ok:
                logger.info(" - Sampling failed in %s, removing directory.", rxdir)
                shutil.rmtree(rxdir)
        counter = rcs[0] - 1
        for ok, rc in zip(success, rcs):
            if ok:
                counter += 1
                if rc != counter:
                    shutil.move(_rxdir(self.rdir, rc), _rxdir(self.rdir, counter))
        self._write_rcount(counter)
        flush_log()
        return counter


def ingest_cde_run(rdir: str, rcount: int, fix_radicals: bool = True,
                   duplicate_reverse: bool = True):
    """Read one CDE run's reaction trajectories (cde.jl:258-316).

    Returns ``(reac_smis, reac_xyzs, reac_systems, prod_smis, prod_xyzs,
    prod_systems, dH)`` with reverse reactions appended when
    ``duplicate_reverse`` (detailed balance seeding).
    """
    rxdir = _rxdir(rdir, rcount)
    rxfiles = sorted(f for f in os.listdir(rxdir) if f.startswith("rxn_"))
    reacs, prods, dH = [], [], []
    for f in rxfiles:
        frames = read_xyz_file(os.path.join(rxdir, f))
        if len(frames) < 2:
            continue
        reacs.append(frames[0])
        prods.append(frames[1])
        dH.append(frames[1]["info"].get("energy", 0.0)
                  - frames[0]["info"].get("energy", 0.0))

    reac_smis, reac_xyzs, reac_systems = [], [], []
    for frame in reacs:
        smis, xyzs = ingest_xyz_system(frame_to_xyz(frame),
                                       fix_radicals=fix_radicals)
        reac_smis.append(smis)
        reac_xyzs.append(xyzs)
        reac_systems.append(frame)
    prod_smis, prod_xyzs, prod_systems = [], [], []
    for frame in prods:
        smis, xyzs = ingest_xyz_system(frame_to_xyz(frame),
                                       fix_radicals=fix_radicals)
        prod_smis.append(smis)
        prod_xyzs.append(xyzs)
        prod_systems.append(frame)

    if duplicate_reverse:
        reac_smis, prod_smis = (reac_smis + prod_smis, prod_smis + reac_smis)
        reac_xyzs, prod_xyzs = (reac_xyzs + prod_xyzs, prod_xyzs + reac_xyzs)
        reac_systems, prod_systems = (reac_systems + prod_systems,
                                      prod_systems + reac_systems)
        dH = dH + [-x for x in dH]

    return (reac_smis, reac_xyzs, reac_systems, prod_smis, prod_xyzs,
            prod_systems, dH)
