"""Entry ``ensemble``: a batch of ramps through ``EnsembleProblem``.

The problem (network, calculator, closures) is built once at set-up, as a
user who sweeps many batches builds it; each ``solve`` is one call of
``EnsembleProblem.solve`` on a batch of ramps (continuous rates, async
chunks), ending in host arrays.
"""
from __future__ import annotations

import numpy as np

from benchmark import port


class Ensemble:
    def __init__(self, config, net, traffic, device):
        from kinetica_tpu_torch.solving.methods import VariableODESolve
        self.T0, self.tf = traffic["ramp"]["T0"], traffic["tf"]
        self.device = device
        sd, rd = port.species_reactions(net)
        calc = port.calculator(config, net, device)
        rate_mode = config["rates"]["rate_mode"]

        def problem(tf):
            from kinetica_tpu_torch.parallel.batching import EnsembleProblem
            pars = port.params(config, traffic, tf)
            cond = port.ramps([traffic["ramp"]["rate_lo"]], self.T0, tf)[0]
            return EnsembleProblem(VariableODESolve(pars, cond, calc), sd, rd,
                                   rate_mode=rate_mode, device=device)

        self.problem = problem(self.tf)
        self.warm_tf = traffic["warmup_chunks"] * traffic["chunk"]
        self._warm = problem(self.warm_tf)

    def warm_up(self, rates: np.ndarray) -> None:
        self._warm.solve(conditions_list=port.ramps(rates, self.T0,
                                                    self.warm_tf))

    def solve(self, rates: np.ndarray) -> port.Solved:
        ens = self.problem.solve(conditions_list=port.ramps(rates, self.T0,
                                                            self.tf))
        return port.Solved(u=np.asarray(ens.u, dtype=np.float64),
                           ok=port.success(ens.retcodes),
                           n_steps=np.asarray(ens.stats["n_steps"]),
                           n_lu=np.asarray(ens.stats["n_lu"]),
                           attempts=int(ens.stats["attempts"]))


make = Ensemble
