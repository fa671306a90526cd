"""KPM calculator family: rate constants from ML-predicted activation energies.

Counterpart of ``kinetica_tpu/calculators/kpm.py`` (capability parity with
the reference's KineticaKPM.jl extension package, Julia reference
docs/src/api/kineticakpm.md:1-21 and
docs/src/tutorials/kinetic-calculators.md:92-186):

* :class:`KPMRun` — the activation-energy predictor: featurise every
  reaction into a fixed-width descriptor vector on the host
  (:func:`reaction_descriptors`), then run an MLP ensemble
  (:class:`KPMEnsemble`, an ``nn.Module`` with the members stacked as
  (M, in, out) weights, tanh between layers, f64 throughout) on the
  device. Ensemble spread gives the Ea uncertainty. The ensemble comes
  from an ``.npz`` file or from the JAX package's ``KPMRun.params``
  (:meth:`KPMEnsemble.from_numpy`), so one file or one dict gives the same
  Ea in both packages. Alternatively ``predict_fn``, or the Evans-Polanyi
  fallback ``Ea = max(0, alpha*dH + beta)``.
* :class:`KPMBasicCalculator` — Arrhenius with the transition-state-theory
  prefactor ``A = RT/h``:  ``k_i = 1/(1/k_max + 1/((RT/h) e^{-E_i/RT}))``
  (kinetic-calculators.md:106-121).
* :class:`KPMCollisionCalculator` — collision-theory prefactor from hard
  sphere parameters: reduced mass ``mu = mA mB/(mA+mB)`` and cross-section
  ``sigma = pi (rA+rB)^2``, with
  ``k_i = sigma_i rho_i N_A sqrt(8 k_b T / pi mu_i) e^{-E_i/RT}``
  (kinetic-calculators.md:129-160). Unimolecular reactions either gain an
  explicit inert collision partner (``inert_species``: ``setup_network``
  rewrites them bimolecular) or collide with a CRN-mean pseudo-species at
  1 mol/dm^3.
* :class:`KPMCollisionEntropyCalculator` — collision calculator whose
  steric factor comes from an activation-entropy estimate
  (``rho = exp(dS_assoc/R)``).

The calculators keep ``Ea``, ``Ea_std``, ``mu``, ``sigma`` and ``rho`` as
f64 tensors on their ``device``; rates are closed forms in T, so every
KPM calculator serves continuous solves (``allows_continuous = True``).
A T of shape S gives rates of shape S + (nr,).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import constants
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.time_units import tconvert
from .base import KineticCalculator

#: Elements tracked individually in the descriptor vector.
_DESC_ELEMENTS = ("H", "C", "N", "O", "S")
#: Total descriptor width (see :func:`reaction_descriptors`).
DESCRIPTOR_DIM = 2 * len(_DESC_ELEMENTS) + 6


def _element_counts(sd, sid):
    from ..chem.graphmol import from_smiles
    from ..chem.xyz import frame_species
    frame = sd.xyz.get(sid)
    if frame is not None:
        species = frame_species(frame)
    else:
        species = from_smiles(sd.toStr[sid]).species
    counts = {}
    for s in species:
        counts[s] = counts.get(s, 0) + 1
    return counts


def reaction_descriptors(sd, rd) -> np.ndarray:
    """Fixed-width per-reaction feature matrix, shape (nr, DESCRIPTOR_DIM).

    Layout: [reactant-side element counts (len 5) | absolute element-count
    change (len 5) | n reactant molecules | n product molecules | total
    reactant atoms | total reactant molecular weight (amu/100) | dH (eV) |
    molecularity-2 flag]. This is the host-side featurisation; the real
    KPM package featurises atom-mapped reaction SMILES, which needs the
    trained model's own vocabulary — any richer featuriser can be swapped
    in via ``KPMRun(featurizer=...)``.
    """
    from ..chem.elements import atomic_mass
    feats = np.zeros((rd.nr, DESCRIPTOR_DIM), dtype=np.float64)
    for j in range(rd.nr):
        reac_counts: dict[str, float] = {}
        prod_counts: dict[str, float] = {}
        n_reac_mol = 0
        n_prod_mol = 0
        weight = 0.0
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            n_reac_mol += st
            ec = _element_counts(sd, sid)
            for el, c in ec.items():
                reac_counts[el] = reac_counts.get(el, 0) + st * c
                weight += st * c * atomic_mass(el)
        for sid, st in zip(rd.id_prods[j], rd.stoic_prods[j]):
            n_prod_mol += st
            for el, c in _element_counts(sd, sid).items():
                prod_counts[el] = prod_counts.get(el, 0) + st * c
        ne = len(_DESC_ELEMENTS)
        for i, el in enumerate(_DESC_ELEMENTS):
            feats[j, i] = reac_counts.get(el, 0)
            feats[j, ne + i] = abs(reac_counts.get(el, 0) - prod_counts.get(el, 0))
        n_atoms = sum(reac_counts.values())
        dh = rd.dH[j] if j < len(rd.dH) else 0.0
        feats[j, 2 * ne:] = (n_reac_mol, n_prod_mol, n_atoms, weight / 100.0,
                             dh, float(n_reac_mol >= 2))
    return feats


class KPMEnsemble(nn.Module):
    """An MLP ensemble with its members stacked: layer ``l`` holds
    ``W[l]`` (M, in, out) and ``b[l]`` (M, out); tanh between layers; the
    input is normalised by ``feat_mean``/``feat_std`` and the output
    denormalised by ``target_std``/``target_mean`` (eV). f64 throughout.
    """

    def __init__(self, W, b, feat_mean, feat_std, target_mean, target_std):
        super().__init__()

        def f64(x):     # a copy: the arrays may be read-only (np.load)
            return torch.tensor(np.asarray(x, dtype=np.float64))
        self.W = nn.ParameterList(
            [nn.Parameter(f64(w), requires_grad=False) for w in W])
        self.b = nn.ParameterList(
            [nn.Parameter(f64(v), requires_grad=False) for v in b])
        for name, v in (("feat_mean", feat_mean), ("feat_std", feat_std),
                        ("target_mean", target_mean),
                        ("target_std", target_std)):
            self.register_buffer(name, f64(v))

    @classmethod
    def from_numpy(cls, params: dict) -> "KPMEnsemble":
        """Build from the JAX package's ``KPMRun.params`` layout, as numpy
        arrays: ``W``/``b`` lists over members of lists over layers, and
        ``feat_mean``, ``feat_std``, ``target_mean``, ``target_std``."""
        W = [np.stack(layer) for layer in zip(*params["W"])]
        b = [np.stack(layer) for layer in zip(*params["b"])]
        return cls(W, b, params["feat_mean"], params["feat_std"],
                   params["target_mean"], params["target_std"])

    @property
    def n_members(self) -> int:
        return self.W[0].shape[0]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """(nr, in) descriptors -> (M, nr) activation energies in eV."""
        h = ((X - self.feat_mean) / self.feat_std)[None]
        for i, (W, b) in enumerate(zip(self.W, self.b)):
            h = torch.matmul(h, W) + b[:, None, :]
            if i < len(self.W) - 1:
                h = torch.tanh(h)
        return h[..., 0] * self.target_std + self.target_mean


def _load_npz_params(path) -> dict:
    """An ``.npz`` model file as the JAX package's ``KPMRun.params`` dict
    (numpy arrays)."""
    data = dict(np.load(path))
    members = sorted({int(k[1:].split("_")[0]) for k in data if k.startswith("W")})
    layers = sorted({int(k.split("_")[1]) for k in data if k.startswith("W")})
    return {
        "W": [[data[f"W{m}_{l}"] for l in layers] for m in members],
        "b": [[data[f"b{m}_{l}"] for l in layers] for m in members],
        "feat_mean": data.get("feat_mean", np.zeros(1)),
        "feat_std": data.get("feat_std", np.ones(1)),
        "target_mean": data.get("target_mean", np.zeros(())),
        "target_std": data.get("target_std", np.ones(())),
    }


class KPMRun:
    """Activation-energy predictor (reference: ``KPMRun(model.npz)``).

    Model file format (``.npz``): for ensemble member ``m`` and layer
    ``l``, arrays ``W{m}_{l}`` (in_dim, out_dim) and ``b{m}_{l}``
    (out_dim,); optional ``feat_mean``/``feat_std`` input normalisation and
    ``target_mean``/``target_std`` output denormalisation (targets in
    eV). Members/layers are discovered from the key set; every member has
    the same layer shapes. Activation is tanh. ``params`` (the JAX
    package's dict layout, numpy arrays) builds the same ensemble without
    a file; the ensemble runs on ``device``.

    Alternatively pass ``predict_fn(descriptors) -> Ea_eV`` (vector or
    (members, nr) matrix for uncertainty), or nothing — the Evans-Polanyi
    fallback ``Ea = max(0, alpha (dH - dH_ref))`` with the package default
    alpha=0.75, dH_ref=-2 eV then applies.
    """

    def __init__(self, model_path: str | None = None, predict_fn=None,
                 featurizer=reaction_descriptors,
                 ep_alpha: float = 0.75, ep_dh_ref: float = -2.0,
                 params: dict | None = None, device=DEFAULT_DEVICE):
        self.model_path = model_path
        self.predict_fn = predict_fn
        self.featurizer = featurizer
        self.ep_alpha = ep_alpha
        self.ep_dh_ref = ep_dh_ref
        self.device = resolve_device(device)
        if model_path is not None:
            params = _load_npz_params(model_path)
        self.params = params
        self.ensemble = (None if params is None else
                         KPMEnsemble.from_numpy(params).to(self.device))

    def __call__(self, sd, rd, uncertainty: bool = False):
        """Predict Ea for every reaction. Returns J/mol (+ sigma if asked),
        host numpy arrays."""
        ev = constants.eV_to_J_per_mol
        if rd.nr == 0:
            z = np.zeros(0)
            return (z, z) if uncertainty else z
        if self.ensemble is not None:
            X = torch.as_tensor(self.featurizer(sd, rd), dtype=torch.float64,
                                device=self.device)
            with torch.no_grad():
                E = self.ensemble(X)
            mean = E.mean(0).cpu().numpy()
            std = E.std(0, correction=0).cpu().numpy()
        elif self.predict_fn is not None:
            E = np.atleast_2d(np.asarray(self.predict_fn(self.featurizer(sd, rd))))
            mean, std = E.mean(0), E.std(0)
        else:  # Evans-Polanyi fallback from tabulated dH
            dh = np.asarray(rd.dH, dtype=np.float64)
            mean = np.maximum(0.0, self.ep_alpha * (dh - self.ep_dh_ref))
            std = np.zeros_like(mean)
        Ea = np.maximum(mean, 0.0) * ev
        return (Ea, std * ev) if uncertainty else Ea


class _KPMCalculatorBase(KineticCalculator):
    allows_continuous = True

    def __init__(self, kpm: KPMRun, uncertainty: bool = False, k_max=None,
                 t_unit: str = "s", device=DEFAULT_DEVICE):
        self.kpm = kpm
        self.uncertainty = uncertainty
        self.k_max = k_max
        self.t_unit = t_unit
        self.t_mult = tconvert(t_unit, "s")
        self.device = resolve_device(device)
        self.Ea = None
        self.Ea_std = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    def _predict(self, sd, rd):
        if self.uncertainty:
            Ea, Ea_std = self.kpm(sd, rd, uncertainty=True)
            self.Ea_std = self._tensor(Ea_std)
        else:
            Ea = self.kpm(sd, rd)
        self.Ea = self._tensor(Ea)

    def splice(self, rids) -> None:
        keep = np.setdiff1d(np.arange(self.Ea.shape[0]),
                            np.asarray(list(rids), dtype=int))
        keep = torch.as_tensor(keep, device=self.device)
        self.Ea = self.Ea[keep]
        if self.Ea_std is not None:
            self.Ea_std = self.Ea_std[keep]
        self._splice_extra(keep)

    def _splice_extra(self, keep) -> None:
        pass

    def has_conditions(self, symbols) -> bool:
        return all(s in ("T",) for s in symbols)

    def _temperature(self, T) -> torch.Tensor:
        """T as an f64 tensor on its own device (the calculator's for a
        float), with a trailing axis against the reactions when batched."""
        dev = T.device if isinstance(T, torch.Tensor) else self.device
        T = torch.as_tensor(T, dtype=torch.float64, device=dev)
        return T[..., None] if T.ndim else T

    def k_uncertainty(self, k, T):
        """First-order propagation: sigma_k = k * sigma_Ea / (R T)."""
        if self.Ea_std is None:
            raise ValueError("Calculator was constructed with uncertainty=False")
        Tb = self._temperature(T)
        return k * self.Ea_std.to(Tb.device) / (constants.R * Tb)


class KPMBasicCalculator(_KPMCalculatorBase):
    """A = RT/h for all reactions (kinetic-calculators.md:106-121)."""

    def setup_network(self, sd, rd) -> None:
        self._predict(sd, rd)

    def __call__(self, T, **_):
        Tb = self._temperature(T)
        Ea = self.Ea.to(Tb.device)
        k = (constants.R * Tb / constants.h) * torch.exp(-Ea / (constants.R * Tb))
        return self._apply_k_max(k * self.t_mult, self.k_max)


def calc_collision_params(sd, rd, inert_pairs=None):
    """Per-reaction reduced mass mu (kg) and cross-section sigma (m^2).

    Mirrors ``KineticaKPM.calc_collision_params``: hard-sphere parameters
    from the per-species weights/radii cached by
    :func:`kinetica_tpu_torch.chem.conversion.get_species_stats`. Unimolecular
    reactions with no inert partner collide with the CRN-average
    pseudo-species.
    """
    amu = constants.amu_to_kg
    w = sd.cache["weights"]
    r = sd.cache["radii"]
    mean_m = float(np.mean([w[i] for i in range(sd.n)]))
    mean_r = float(np.mean([r[i] for i in range(sd.n)]))
    mu = np.zeros(rd.nr)
    sigma = np.zeros(rd.nr)
    for j in range(rd.nr):
        parts = []
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            parts.extend([sid] * st)
        if len(parts) == 1:
            mA, rA = w[parts[0]], r[parts[0]]
            mB, rB = mean_m, mean_r
        else:
            mA, rA = w[parts[0]], r[parts[0]]
            mB, rB = w[parts[1]], r[parts[1]]
        mu[j] = (mA * mB) / (mA + mB) * amu
        sigma[j] = np.pi * ((rA + rB) * 1e-10) ** 2
    return mu, sigma


def calc_steric_factors(sd, rd, method, mu=None, sigma=None) -> np.ndarray:
    """Empirical steric factors rho_i in (0, 1].

    Capability equivalent of ``KineticaKPM.calc_steric_factors`` (exact
    formulas unpublished in the reference repo). Methods:

    * ``None`` / ``"none"`` — rho = 1.
    * ``"basic"`` — size heuristic: rho = (6/N_atoms)^2 capped at 1;
      encodes that larger colliders have proportionally fewer reactive
      orientations.
    * ``"entropy"`` — rho = exp(dS_assoc/R) with the association entropy
      estimated as the Sackur-Tetrode translational entropy lost when the
      two colliders merge at standard concentration (bimolecular only).
    """
    if method in (None, "none"):
        return np.ones(rd.nr)
    rho = np.ones(rd.nr)
    if method == "basic":
        for j in range(rd.nr):
            n_atoms = 0
            for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
                frame = sd.xyz.get(sid)
                if frame is not None:
                    n_atoms += st * int(frame["N_atoms"])
                else:
                    from ..chem.graphmol import from_smiles
                    n_atoms += st * len(from_smiles(sd.toStr[sid]).species)
            rho[j] = min(1.0, (6.0 / max(n_atoms, 1)) ** 2)
        return rho
    if method == "entropy":
        w = sd.cache["weights"]
        T_ref = 298.15
        c0 = 1000.0 * constants.N_A          # 1 mol/dm^3 in molecules/m^3
        lam = lambda m: constants.h / np.sqrt(
            2 * np.pi * m * constants.k_b * T_ref)
        for j in range(rd.nr):
            parts = []
            for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
                parts.extend([sid] * st)
            if len(parts) < 2:
                continue
            mA = w[parts[0]] * constants.amu_to_kg
            mB = w[parts[1]] * constants.amu_to_kg
            mu_j = mA * mB / (mA + mB)
            # Sackur-Tetrode entropy of the lost relative-translation DOF
            dS = -constants.R * (np.log(1.0 / (c0 * lam(mu_j) ** 3)) + 2.5)
            rho[j] = min(1.0, np.exp(dS / constants.R / 10.0))
        return rho
    raise ValueError(f"Unknown steric factor method {method!r}")


class KPMCollisionCalculator(_KPMCalculatorBase):
    """Collision-theory prefactors (kinetic-calculators.md:129-160).

    ``k_i = sigma_i rho_i N_A sqrt(8 k_b T / pi mu_i) e^{-E_i/RT}`` in
    m^3 mol^-1 s^-1, converted to the framework's dm^3 mol^-1 s^-1.
    """

    def __init__(self, kpm: KPMRun, inert_species=None, steric_factor=None,
                 uncertainty: bool = False, k_max=None, t_unit: str = "s",
                 device=DEFAULT_DEVICE):
        super().__init__(kpm, uncertainty, k_max, t_unit, device)
        self.inert_species = inert_species
        self.steric_factor = steric_factor
        self.mu = None
        self.sigma = None
        self.rho = None

    def setup_network(self, sd, rd) -> None:
        from ..chem.conversion import get_species_stats
        from ..solving.solve_utils import insert_inert
        if self.inert_species:
            insert_inert(rd, sd, list(self.inert_species))
        get_species_stats(sd)
        mu, sigma = calc_collision_params(sd, rd)
        self.mu = self._tensor(mu)
        self.sigma = self._tensor(sigma)
        self.rho = self._tensor(
            calc_steric_factors(sd, rd, self.steric_factor, mu, sigma))
        self._predict(sd, rd)

    def _splice_extra(self, keep) -> None:
        self.mu = self.mu[keep]
        self.sigma = self.sigma[keep]
        self.rho = self.rho[keep]

    def __call__(self, T, **_):
        Tb = self._temperature(T)
        dev = Tb.device
        v_rel = torch.sqrt(8.0 * constants.k_b * Tb / (np.pi * self.mu.to(dev)))
        A = (self.sigma.to(dev) * self.rho.to(dev) * constants.N_A * v_rel
             * 1e3)  # dm^3/mol/s
        k = A * torch.exp(-self.Ea.to(dev) / (constants.R * Tb))
        return self._apply_k_max(k * self.t_mult, self.k_max)


class KPMCollisionEntropyCalculator(KPMCollisionCalculator):
    """Collision calculator with the entropy-derived steric factor."""

    def __init__(self, kpm: KPMRun, inert_species=None,
                 uncertainty: bool = False, k_max=None, t_unit: str = "s",
                 device=DEFAULT_DEVICE):
        super().__init__(kpm, inert_species=inert_species,
                         steric_factor="entropy", uncertainty=uncertainty,
                         k_max=k_max, t_unit=t_unit, device=device)
