"""Numeric mass-action formulation of a CRN, in PyTorch.

Counterpart of ``kinetica_tpu/models/mass_action.py``. The network is the
same fixed-shape description built once on the host:

* ``reac_slots`` — (nr, arity) indices into ``u_aug = [clip_pos(u), 1]``;
  padding slots point at the trailing constant (index ns), so each rate
  is exactly ``k_j * prod_s u_aug[slot_js]``;
* ``N`` — (nr, ns) net stoichiometry, so ``du = r @ N``.

:class:`MassActionNetwork` is an ``nn.Module`` whose buffers are those two
arrays; every kinetics function takes u of shape (..., ns) and k of shape
(..., nr), so one call serves a batch of lanes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.network import RxData
from ..device import DEFAULT_DEVICE, resolve_device

# Smoothing half-width of the clipped-concentration kink (see _clip_pos).
CLIP_DELTA = 1e-12


def resolve_clip_delta(pars=None) -> float:
    """``pars.clip_delta`` if explicit, else ``min(CLIP_DELTA, 0.01 * abstol)``."""
    if pars is None:
        return CLIP_DELTA
    choice = getattr(pars, "clip_delta", "auto")
    if choice == "auto":
        return min(CLIP_DELTA, 0.01 * float(getattr(pars, "abstol", 1e-10)))
    return float(choice)


def _clip_pos(u: torch.Tensor, delta: float = CLIP_DELTA) -> torch.Tensor:
    """C^inf positive part u * sigmoid(u / delta); exactly 0 at u = 0.

    Rates are evaluated on the nonnegative part of u; the smooth form keeps
    RHS and Jacobian consistent when a species crosses zero at the
    tolerance floor (see the reference's ``_clip_pos`` for the measured
    reasons)."""
    return u * torch.sigmoid(u / delta)


def _clip_pos_grad(u: torch.Tensor, delta: float = CLIP_DELTA) -> torch.Tensor:
    """d(_clip_pos)/du — chain factor for the Jacobian."""
    x = u / delta
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def augment(u: torch.Tensor, delta: float) -> torch.Tensor:
    """``[clip_pos(u), 1]`` along the last axis."""
    one = torch.ones(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    return torch.cat([_clip_pos(u, delta), one], dim=-1)


class MassActionNetwork(nn.Module):
    """Padded dense arrays describing the mass-action kinetics of one CRN."""

    def __init__(self, reac_slots: torch.Tensor, N: torch.Tensor,
                 delta: float = CLIP_DELTA):
        super().__init__()
        self.register_buffer("reac_slots", reac_slots.long())
        self.register_buffer("N", N)
        self.delta = float(delta)

    @classmethod
    def from_numpy(cls, reac_slots, N, delta: float = CLIP_DELTA,
                   device=DEFAULT_DEVICE,
                   dtype=torch.float64) -> "MassActionNetwork":
        """Build from host arrays, e.g. ``np.asarray(jax_net.N)``."""
        # np.array copies: arrays taken from jax are read-only
        device = resolve_device(device)
        return cls(torch.as_tensor(np.array(reac_slots, dtype=np.int64),
                                   device=device),
                   torch.as_tensor(np.array(N), dtype=dtype, device=device),
                   delta=delta)

    @property
    def ns(self) -> int:
        return self.N.shape[1]

    @property
    def nr(self) -> int:
        return self.N.shape[0]

    @property
    def arity(self) -> int:
        return self.reac_slots.shape[1]

    def rates(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Per-reaction rates r_j = k_j * prod_s u_aug[slot_js]."""
        return k * augment(u, self.delta)[..., self.reac_slots].prod(dim=-1)

    def rhs(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """du/dt = r @ N."""
        return self.rates(u, k) @ self.N

    def _jac_onehot(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """J^T = sum_s E_s^T @ (w_s * N) in N's dtype.

        ``E_s`` is the one-hot (nr, ns+1) slot matrix of slot s and
        ``w_s = k * prod_{s' != s} u_aug[slot_s']``. Every entry is a sum in
        a fixed order (a dense matmul), so a CUDA run gives the same J each
        time; a scatter-add form would not (its f32 atomics reorder)."""
        dt = self.N.dtype
        ns = self.ns
        u_aug = augment(u, self.delta).to(dt)
        chain = _clip_pos_grad(u, self.delta).to(dt)
        su = u_aug[..., self.reac_slots]                   # (..., nr, arity)
        k = k.to(dt)
        JT = None
        for s in range(self.arity):
            w = k
            for s2 in range(self.arity):
                if s2 != s:
                    w = w * su[..., s2]
            E = nn.functional.one_hot(self.reac_slots[:, s], ns + 1).to(dt)
            term = E.T @ (w[..., :, None] * self.N)        # (..., ns+1, ns)
            JT = term if JT is None else JT + term
        return JT[..., :ns, :].transpose(-1, -2) * chain[..., None, :]

    def jac(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Analytic Jacobian d(du/dt)/du, (..., ns, ns), in N's dtype (f64)."""
        return self._jac_onehot(u, k)

    def rhs_and_jac(self, u: torch.Tensor, k: torch.Tensor):
        """``(rhs(u, k), jac(u, k))``, as the reference's."""
        return self.rhs(u, k), self.jac(u, k)

    def jac_matmul(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """The same Jacobian; the main path calls it on an f32 network
        (the Newton preconditioner), as the reference's ``jac_matmul``."""
        return self._jac_onehot(u, k)

    def jac_segsum(self, u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """The same Jacobian as a segment sum over the (reaction, slot)
        pairs (``jac_form="segsum"``, the reference's ``jac``):
        J^T[m] = sum_{(j, s): slot_js = m} w_js N[j], in (j, s) order on
        either device: ``index_add_`` on the CPU, and on a CUDA device the
        sorted accumulation of ``index_put_(accumulate=True)`` (a stable
        sort), where ``index_add_`` would add in the atomics' order and
        identical lanes could round apart."""
        dt = self.N.dtype
        ns, nr, arity = self.ns, self.nr, self.arity
        u_aug = augment(u, self.delta).to(dt)
        chain = _clip_pos_grad(u, self.delta).to(dt)
        su = u_aug[..., self.reac_slots]                   # (..., nr, arity)
        k = k.to(dt)
        w = torch.stack([
            k * torch.prod(su[..., [s2 for s2 in range(arity) if s2 != s]],
                           dim=-1)
            for s in range(arity)], dim=-1)                # (..., nr, arity)
        Y = (self.N[:, None, :] * w[..., None]).reshape(
            *w.shape[:-2], nr * arity, ns)
        JT = torch.zeros(*Y.shape[:-2], ns + 1, ns, dtype=dt, device=Y.device)
        slots = self.reac_slots.reshape(-1)
        if Y.device.type == "cuda":
            JT = JT.movedim(-2, 0).index_put_(
                (slots,), Y.movedim(-2, 0), accumulate=True).movedim(0, -2)
        else:
            JT.index_add_(JT.ndim - 2, slots, Y)
        return JT[..., :ns, :].transpose(-1, -2) * chain[..., None, :]

    def to_dtype(self, dtype) -> "MassActionNetwork":
        """A copy whose stoichiometry is in ``dtype`` (e.g. the f32 Jacobian net)."""
        return MassActionNetwork(self.reac_slots, self.N.to(dtype), self.delta)

    def block(self, lo: int, hi: int) -> "MassActionNetwork":
        """The reactions ``[lo, hi)`` as a network of their own (a model
        rank's share of a reaction-sharded solve). Every kinetics function
        of the block, given that block's k, returns its share of the whole
        network's: rates, ``rhs`` and each Jacobian form sum over the
        block's reactions only, so the shares of a partition add up to
        the network's value."""
        if not 0 <= lo <= hi <= self.nr:
            raise ValueError(f"reaction block [{lo}, {hi}) outside "
                             f"[0, {self.nr})")
        return MassActionNetwork(self.reac_slots[lo:hi], self.N[lo:hi],
                                 self.delta)


def build_mass_action(rd: RxData, ns: int, device=DEFAULT_DEVICE,
                      dtype=torch.float64, min_arity: int = 2,
                      clip_delta: float = CLIP_DELTA) -> MassActionNetwork:
    """Compile an :class:`RxData` into padded dense arrays on ``device``."""
    nr = rd.nr
    arity = max([min_arity] + [sum(s) for s in rd.stoic_reacs]) if nr else min_arity
    reac_slots = np.full((max(nr, 1), arity), ns, dtype=np.int64)
    N = np.zeros((max(nr, 1), ns), dtype=np.float64)
    for j in range(nr):
        slot = 0
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            N[j, sid] -= st
            for _ in range(st):
                reac_slots[j, slot] = sid
                slot += 1
        for sid, st in zip(rd.id_prods[j], rd.stoic_prods[j]):
            N[j, sid] += st
    return MassActionNetwork.from_numpy(reac_slots, N, delta=clip_delta,
                                        device=device, dtype=dtype)


def pad_reactions(net: MassActionNetwork, nr_padded: int) -> MassActionNetwork:
    """Pad the reaction axis with inert reactions up to ``nr_padded``.

    Padding reactions reference only the constant-1 slot and carry zero
    stoichiometry, so with zero-padded rates they contribute nothing."""
    nr, ns = net.nr, net.ns
    if nr_padded < nr:
        raise ValueError(f"nr_padded {nr_padded} < nr {nr}")
    if nr_padded == nr:
        return net
    pad = nr_padded - nr
    slots = torch.cat([net.reac_slots,
                       torch.full((pad, net.arity), ns, dtype=torch.int64,
                                  device=net.N.device)])
    N = torch.cat([net.N, torch.zeros((pad, ns), dtype=net.N.dtype,
                                      device=net.N.device)])
    return MassActionNetwork(slots, N, delta=net.delta)


def fd_jacobian(net: MassActionNetwork, u: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """Autodiff Jacobian d(net.rhs)/du by forward mode (``torch.func.jacfwd``),
    used in tests to hold the analytic one. ``u`` (ns,) and ``k`` (nr,)
    give (ns, ns); a batch ``u`` (B, ns), ``k`` (B, nr) gives (B, ns, ns)."""
    def one(uu, kk):
        return torch.func.jacfwd(lambda x: net.rhs(x, kk))(uu)
    if u.ndim == 1:
        return one(u, k)
    return torch.func.vmap(one)(u, k)
