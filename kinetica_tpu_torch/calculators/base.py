"""Kinetic calculator interface (counterpart of
``kinetica_tpu/calculators/base.py``).

A calculator implements ``setup_network(sd, rd)``, ``splice(rids)``,
``has_conditions(symbols)``, ``allows_continuous`` and
``__call__(**conditions)``, which returns the per-reaction rate-constant
tensor. Conditions may be floats or tensors; a tensor of shape (B,) gives
rates of shape (B, nr), which is how the batched continuous solve embeds
k(T(t)) per lane.
"""
from __future__ import annotations

import torch


class KineticCalculator:
    allows_continuous: bool = False

    def setup_network(self, sd, rd) -> None:
        raise NotImplementedError

    def splice(self, rids) -> None:
        raise NotImplementedError

    def has_conditions(self, symbols) -> bool:
        raise NotImplementedError

    def __call__(self, **conditions) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _apply_k_max(k, k_max):
        """Harmonic cap 1/(1/k_max + 1/k) (reference calculator.jl:223-226)."""
        if k_max is None:
            return k
        return 1.0 / (1.0 / k_max + 1.0 / k)
