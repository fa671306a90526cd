"""Exploration location cursor and restart scanning.

Same capability as Julia reference src/exploration/location.jl: the
(rdir_head, level, subspace) cursor with ``level_%03d/subspace_%03d`` paths
(location.jl:32-38), and the restart scan that finds the latest level with
``seeds.in`` and the first unconverged subspace (location.jl:56-97).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils.logging import logger


@dataclass
class ExploreLoc:
    rdir_head: str
    level: int
    subspace: int

    def path(self, to_level: bool = False) -> str:
        lv = os.path.join(self.rdir_head, f"level_{self.level:03d}")
        if to_level:
            return lv
        return os.path.join(lv, f"subspace_{self.subspace:03d}")

    def inc_level(self):
        self.level += 1

    def inc_subspace(self):
        self.subspace += 1

    def reset_subspace(self):
        self.subspace = 1


def find_current_loc(rdir_head: str) -> ExploreLoc:
    """Restart scan (location.jl:56-97); level 0 means 'fresh start'."""
    level_dirs = sorted(d for d in os.listdir(rdir_head)
                        if d.startswith("level_")) if os.path.isdir(rdir_head) else []
    if not level_dirs:
        logger.info("No network levels found in %s, starting network "
                    "exploration from scratch.", rdir_head)
        return ExploreLoc(rdir_head, 0, 1)

    curr = level_dirs[-1]
    level = int(curr.split("_")[-1])
    if not os.path.isfile(os.path.join(rdir_head, curr, "seeds.in")):
        logger.info("No seeds.in found in level %d, continuing from previous "
                    "level.", level)
        curr = level_dirs[-2]
        level -= 1
    level_dir = os.path.join(rdir_head, curr)

    ss_dirs = sorted(d for d in os.listdir(level_dir)
                     if d.startswith("subspace_"))
    if not ss_dirs:
        logger.info("No subspaces found in level %d, starting level "
                    "exploration from scratch.", level)
        return ExploreLoc(rdir_head, level, 1)

    subspace = 1
    for i, ss in enumerate(ss_dirs, start=1):
        subspace = i
        if not os.path.isfile(os.path.join(level_dir, ss, "isconv")):
            logger.info("Current exploration location: Level %d, Subspace %d",
                        level, subspace)
            return ExploreLoc(rdir_head, level, subspace)

    logger.warning("All subspaces in level %d are converged!", level)
    logger.info("Current exploration location: Level %d, Subspace %d",
                level, subspace)
    return ExploreLoc(rdir_head, level, subspace)
