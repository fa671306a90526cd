"""Entry ``solve_network``: one ramp a call through ``solve_network``.

Each ``solve`` is one call of ``solving.methods.solve_network`` on a
batch of one ramp (chunkwise, continuous rates), as a user who solves one
profile at a time makes it: the call copies and sets up the network, runs
the chunks and returns host arrays.
"""
from __future__ import annotations

import numpy as np

from benchmark import port


class Single:
    def __init__(self, config, net, traffic, device):
        if traffic["batch"] != 1:
            raise ValueError("solve_network solves one ramp a call")
        self.T0, self.tf = traffic["ramp"]["T0"], traffic["tf"]
        self.device = device
        self.sd, self.rd = port.species_reactions(net)
        self.calc = port.calculator(config, net, device)
        self.pars = port.params(config, traffic, self.tf)
        self.warm_tf = traffic["warmup_chunks"] * traffic["chunk"]
        self.warm_pars = port.params(config, traffic, self.warm_tf)

    def _call(self, pars, rate: float, tf: float):
        from kinetica_tpu_torch.solving.methods import (VariableODESolve,
                                                        solve_network)
        cond = port.ramps([rate], self.T0, tf)[0]
        return solve_network(VariableODESolve(pars, cond, self.calc), self.sd,
                             self.rd, device=self.device).sol

    def warm_up(self, rates: np.ndarray) -> None:
        self._call(self.warm_pars, float(rates[0]), self.warm_tf)

    def solve(self, rates: np.ndarray) -> port.Solved:
        if len(rates) != 1:
            raise ValueError("solve_network solves one ramp a call")
        sol = self._call(self.pars, float(rates[0]), self.tf)
        return port.Solved(u=np.asarray(sol.u, dtype=np.float64)[None],
                           ok=np.array([sol.success]),
                           n_steps=np.array([sol.stats["n_steps"]]),
                           n_lu=np.array([sol.stats["n_lu"]]),
                           attempts=int(sol.stats["attempts"]))


make = Single
