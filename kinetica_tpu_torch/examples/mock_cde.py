#!/usr/bin/env python3
"""Mock CDE executable for demonstrations and tests.

Implements the CDE file contract (reads Start.xyz + input in its working
directory; writes rxn_0001_step_0001.xyz and input.log) with a random
single-bond homolysis move on one molecule of the seed system: the port
of ``examples/mock_cde.py``. The CDE runner starts it as an executable in
a run directory (``[cde_exec, "input"]``), so it puts the checkout that
holds it on ``sys.path`` itself. Use as
``CDE(cde_exec=<path of this file>, ...)`` when the real Fortran CDE
binary is unavailable.
"""
import os
import random
import sys

import numpy as np

_repo = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _repo not in sys.path:
    sys.path.insert(0, _repo)

from kinetica_tpu_torch.chem import (frame_positions, frame_species,  # noqa: E402
                                     make_frame, read_xyz_file,
                                     write_xyz_file)
from kinetica_tpu_torch.chem.graphmol import perceive_connectivity  # noqa: E402


def main():
    seed = 1
    with open("input") as fh:
        for line in fh:
            parts = line.split()
            if parts[:1] == ["ranseed"]:
                seed = int(parts[1])
    rng = random.Random(seed)

    start = read_xyz_file("Start.xyz")[0]
    species = frame_species(start)
    pos = frame_positions(start)
    system = perceive_connectivity(species, pos)

    import networkx as nx
    comps = [sorted(c) for c in nx.connected_components(system.to_nx())]
    comp = comps[rng.randrange(len(comps))]
    sub_species = [species[i] for i in comp]
    sub_pos = pos[comp]
    mol = perceive_connectivity(sub_species, sub_pos)
    bonds = sorted(mol.bonds)

    e0 = -100.0
    if not bonds:
        reac = make_frame(sub_species, sub_pos, {"energy": e0})
        prod = make_frame(sub_species, sub_pos + 0.01, {"energy": e0})
        write_xyz_file("rxn_0001_step_0001.xyz", [reac, prod])
        with open("input.log", "w") as fh:
            fh.write("mock CDE finished OK (no-op)\n")
        return

    a, b = bonds[rng.randrange(len(bonds))]
    g = mol.to_nx()
    g.remove_edge(a, b)
    side_b = nx.node_connected_component(g, b)
    new_pos = sub_pos.copy()
    direction = sub_pos[b] - sub_pos[a]
    direction = direction / (np.linalg.norm(direction) + 1e-9)
    for i in side_b:
        new_pos[i] = new_pos[i] + direction * 20.0

    e1 = e0 + rng.uniform(1.0, 5.0)
    write_xyz_file("rxn_0001_step_0001.xyz",
                   [make_frame(sub_species, sub_pos, {"energy": e0}),
                    make_frame(sub_species, new_pos, {"energy": e1})])
    with open("input.log", "w") as fh:
        fh.write("mock CDE finished OK\n")


if __name__ == "__main__":
    main()
