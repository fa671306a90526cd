"""Skeletal mechanism reduction via directed relation graphs (DRG/DRGEP).

Counterpart of ``kinetica_tpu/analysis/reduction.py``: error-controlled
reduction of a solved CRN to the reactions that matter for chosen target
species. DRG (Lu & Law, Proc. Combust. Inst. 30 (2005) 1333-1341) keeps
the species reachable from the targets through edges whose direct
interaction coefficient

    r_AB(t) = sum_{j : B participates in j} |nu_Aj w_j(t)|
              / sum_j |nu_Aj w_j(t)|

(maximised over sampled trajectory times, w_j the reaction flux) is at
least eps; a reaction is kept iff every participating species is.
DRGEP (Pepiot-Desjardins & Pitsch, Combust. Flame 154 (2008) 67-81)
damps importance geometrically along the path (R_TB = max over paths of
the product of edge coefficients) with a net-over-max(production,
consumption) coefficient. ``reduce_network_drg`` walks an eps ladder from
aggressive to conservative and returns the smallest mechanism whose
re-solve reproduces the targets within ``tol``.

The graph work is the reference's host numpy; the full solve and the
validation re-solves run through the port's ``solve_network`` on
``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..device import DEFAULT_DEVICE
from .flux import _k_of_time, _mass_action_arrays


def _sampled_fluxes(out, calc, n_samples):
    """Shared sampling front-end for the adjacency builders: returns
    ``(N, P, rates)`` — the (nr, ns) net-stoichiometry matrix, the
    (nr, ns) participation indicator (1 if the species appears on either
    side, catalytic included), and the (nt', nr) instantaneous reaction
    fluxes at ``n_samples`` evenly-strided save-grid times."""
    sd, rd = out.sd, out.rd
    N, slots = _mass_action_arrays(sd, rd)            # (nr, ns), (nr, arity)
    t = np.asarray(out.sol.t, dtype=np.float64)
    u = np.asarray(out.sol.u, dtype=np.float64)
    k_t = np.asarray(_k_of_time(out, calc), dtype=np.float64)

    # participation: P[j, B] = 1 if B appears in reaction j (either side)
    P = (N != 0).astype(np.float64)
    for j in range(rd.nr):
        for sid in rd.id_reacs[j]:
            P[j, sid] = 1.0                   # catalytic reactants have nu=0
        for sid in rd.id_prods[j]:
            P[j, sid] = 1.0

    stride = max(1, t.size // n_samples)
    idx = np.arange(0, t.size, stride)
    u_s = np.maximum(u[idx], 0.0)

    # QSS reconstruction for sub-tolerance intermediates (the
    # reference's): a stored trajectory resolves concentrations only down
    # to ~abstol, and the nonnegative projection clamps quasi-steady
    # radicals to exactly zero at many save points, so fluxes through
    # them would vanish from the sampled graph and the selection would
    # under-keep. For each sampled time, species below ``floor`` get the
    # QSS estimate u_A = P_A / lambda_A: gross production over the
    # first-order consumption-rate coefficient (reactions consuming two
    # A are ~u_A^2 and excluded from lambda). The estimate feeds only the
    # reduction graph, never the solution; every reduced mechanism is
    # still validated by full re-solves.
    ns = N.shape[1]
    nr, arity = slots.shape
    floor = 10.0 * float(getattr(out.pars, "abstol", 1e-10) or 1e-10)
    consumed = np.zeros((nr, ns))
    for j in range(rd.nr):
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            consumed[j, sid] = st
    prod_pos = np.maximum(N, 0.0)                     # (nr, ns)
    for i in range(u_s.shape[0]):
      # chained intermediates (radical B produced only through radical
      # A) need the reconstruction to propagate: iterate to fixed point
      for _pass in range(4):
        ui = u_s[i]
        low = ui < floor
        if not low.any():
            break
        u_aug_i = np.append(ui, 1.0)
        w_i = k_t[idx[i]] * u_aug_i[slots].prod(axis=1)       # (nr,)
        P_A = w_i @ prod_pos                                   # (ns,)
        # lambda_A: sum over first-order-in-A consuming reactions of
        # k_j * product of the OTHER slot concentrations
        lam = np.zeros(ns)
        for sid in np.flatnonzero(low):
            first_order = consumed[:, sid] == 1
            if not first_order.any():
                continue
            js = np.flatnonzero(first_order)
            others = np.ones(js.size)
            for s in range(arity):
                col = slots[js, s]
                mask_self = col == sid
                # divide out exactly one occurrence of A
                vals = u_aug_i[col]
                vals = np.where(mask_self, 1.0, vals)
                # only the FIRST self slot is divided out; with
                # first-order reactions there is exactly one
                others = others * vals
            lam[sid] = np.sum(k_t[idx[i], js] * others)
        with np.errstate(over="ignore", invalid="ignore"):
            qss = np.where(lam > 0.0, P_A / np.maximum(lam, 1e-300), 0.0)
        u_s[i] = np.where(low & (qss > ui), np.minimum(qss, floor), ui)

    u_aug = np.concatenate([u_s, np.ones((idx.size, 1))], axis=1)
    rates = k_t[idx] * u_aug[:, slots].prod(axis=2)   # (nt', nr)
    return N, P, rates


def drg_adjacency(out, calc=None, n_samples: int = 64) -> np.ndarray:
    """(ns, ns) DRG direct-interaction matrix r_AB for a solved network.

    ``out`` is an :class:`~kinetica_tpu_torch.analysis.io.ODESolveOutput`;
    ``calc`` is required when the solve stored no discrete rate table
    (continuous/static formalism), as in
    :func:`kinetica_tpu_torch.analysis.flux.reaction_fluxes`. The coefficient
    is maximised over ``n_samples`` save-grid times (evenly strided),
    the standard conservative choice: a coupling that matters at ANY
    point of the trajectory keeps the edge.
    """
    N, P, rates = _sampled_fluxes(out, calc, n_samples)
    ns = N.shape[1]
    r = np.zeros((ns, ns))
    absN = np.abs(N)
    for i in range(rates.shape[0]):
        W = absN * np.abs(rates[i])[:, None]          # (nr, ns) |nu_Aj w_j|
        den = W.sum(axis=0)                           # (ns,) per A
        num = W.T @ P                                 # (ns_A, ns_B)
        with np.errstate(invalid="ignore", divide="ignore"):
            ri = np.where(den[:, None] > 0.0, num / den[:, None], 0.0)
        np.maximum(r, ri, out=r)
    np.fill_diagonal(r, 0.0)
    return r


def drgep_adjacency(out, calc=None, n_samples: int = 64) -> np.ndarray:
    """(ns, ns) DRGEP direct-interaction matrix.

    Pepiot-Desjardins & Pitsch (2008), eq. 4: for species A, B

        r_AB = |sum_{j : B in j} nu_Aj w_j| / max(P_A, C_A)

    with P_A = sum_j max(0, nu_Aj w_j) the gross production of A and
    C_A = sum_j max(0, -nu_Aj w_j) its gross consumption. Unlike DRG's
    gross-over-gross ratio, cancelling fluxes through B do NOT inflate
    the coupling (a fast quasi-equilibrated channel with no net effect
    on A scores ~0). Maximised over the sampled trajectory times.
    """
    N, P, rates = _sampled_fluxes(out, calc, n_samples)
    ns = N.shape[1]
    r = np.zeros((ns, ns))
    for i in range(rates.shape[0]):
        S = N * rates[i][:, None]                     # (nr, ns) nu_Aj w_j
        prod = np.maximum(S, 0.0).sum(axis=0)         # (ns,) P_A
        cons = np.maximum(-S, 0.0).sum(axis=0)        # (ns,) C_A
        den = np.maximum(prod, cons)
        num = np.abs(S.T @ P)                         # (ns_A, ns_B) |net|
        with np.errstate(invalid="ignore", divide="ignore"):
            ri = np.where(den[:, None] > 0.0, num / den[:, None], 0.0)
        np.maximum(r, ri, out=r)
    np.fill_diagonal(r, 0.0)
    return np.minimum(r, 1.0)


def drgep_coefficients(rAB: np.ndarray, target_ids) -> np.ndarray:
    """(ns,) overall importance R_B = max over targets T and paths
    p(T -> B) of the product of edge coefficients along p.

    Max-product Dijkstra from the target set: edge weights are in
    [0, 1], so path products only decrease and the standard greedy
    settle order is exact. Targets themselves get R = 1.
    """
    import heapq

    ns = rAB.shape[0]
    R = np.zeros(ns)
    heap = []
    for tid in target_ids:
        R[int(tid)] = 1.0
        heapq.heappush(heap, (-1.0, int(tid)))
    settled = np.zeros(ns, dtype=bool)
    while heap:
        negv, a = heapq.heappop(heap)
        if settled[a]:
            continue
        settled[a] = True
        va = -negv
        for b in np.nonzero(rAB[a] > 0.0)[0]:
            cand = va * rAB[a, b]
            if cand > R[b]:
                R[b] = cand
                heapq.heappush(heap, (-cand, int(b)))
    return R


def drg_select(rAB: np.ndarray, target_ids, eps: float) -> np.ndarray:
    """(ns,) bool mask of species reachable from ``target_ids`` through
    edges with r_AB >= eps (directed BFS from the targets)."""
    ns = rAB.shape[0]
    keep = np.zeros(ns, dtype=bool)
    stack = [int(s) for s in target_ids]
    keep[stack] = True
    adj = rAB >= eps
    while stack:
        a = stack.pop()
        for b in np.nonzero(adj[a])[0]:
            if not keep[b]:
                keep[b] = True
                stack.append(int(b))
    return keep


@dataclass
class ReducedNetwork:
    """One DRG reduction at a fixed eps: which species/reactions survive.

    ``apply(sd, rd, calc)`` returns deep-copied ``(rd2, calc2)`` with the
    dropped reactions spliced out — the original ``sd`` remains valid
    (dropped species simply become inert), so solution vectors stay
    comparable index-for-index with the full network's.
    """
    eps: float
    keep_species: np.ndarray          # (ns,) bool
    keep_rids: list = field(default_factory=list)
    n_species_full: int = 0
    n_reactions_full: int = 0

    @property
    def n_species(self) -> int:
        return int(self.keep_species.sum())

    @property
    def n_reactions(self) -> int:
        return len(self.keep_rids)

    def apply(self, rd, calc):
        rd2 = rd.copy()
        import copy as _copy
        calc2 = _copy.deepcopy(calc)
        drop = sorted(set(range(rd.nr)) - set(self.keep_rids))
        rd2.splice(drop)
        calc2.splice(drop)
        return rd2, calc2

    def compact(self, sd, rd):
        """Fresh ``(sd2, rd2, species_map)`` with dropped species
        renumbered away; ``species_map[old_id] = new_id`` (or -1)."""
        from ..core.network import RxData, SpeciesData
        kept = np.nonzero(self.keep_species)[0]
        sd2 = SpeciesData([sd.toStr[int(i)] for i in kept])
        smap = np.full(sd.n, -1, dtype=np.int64)
        smap[kept] = np.arange(kept.size)
        reacs, prods, dH = [], [], []
        for rid in self.keep_rids:
            reacs.append([sd.toStr[s] for s, st in
                          zip(rd.id_reacs[rid], rd.stoic_reacs[rid])
                          for _ in range(st)])
            prods.append([sd.toStr[s] for s, st in
                          zip(rd.id_prods[rid], rd.stoic_prods[rid])
                          for _ in range(st)])
            dH.append(rd.dH[rid])
        rd2 = RxData.from_reactions(sd2, reacs, prods, dH=dH,
                                    unique_rxns=False)
        return sd2, rd2, smap


def _network_from_species_mask(keep_sp: np.ndarray, rd, eps: float
                               ) -> ReducedNetwork:
    """Reactions survive iff every participating species survives."""
    keep_rids = [j for j in range(rd.nr)
                 if all(keep_sp[s] for s in rd.id_reacs[j])
                 and all(keep_sp[s] for s in rd.id_prods[j])]
    return ReducedNetwork(eps=eps, keep_species=keep_sp,
                          keep_rids=keep_rids,
                          n_species_full=keep_sp.shape[0],
                          n_reactions_full=rd.nr)


def reduce_at_eps(rAB: np.ndarray, rd, target_ids, eps: float
                  ) -> ReducedNetwork:
    """The DRG reduction of one adjacency matrix at one threshold."""
    return _network_from_species_mask(drg_select(rAB, target_ids, eps),
                                      rd, eps)


def reduce_at_eps_drgep(R: np.ndarray, rd, eps: float) -> ReducedNetwork:
    """The DRGEP reduction of one importance vector at one threshold:
    keep species with overall importance R_B >= eps."""
    return _network_from_species_mask(R >= eps, rd, eps)


@dataclass
class DRGReductionResult:
    """Outcome of an error-controlled DRG reduction sweep.

    ``reduction`` is the accepted (smallest within-tolerance) mechanism;
    ``ladder`` records every (eps, n_species, n_reactions, max target
    error) candidate evaluated, most aggressive first. ``error`` is the
    accepted candidate's max |target mole-fraction difference| against
    the full solve over the common save grid.
    """
    reduction: ReducedNetwork
    error: float
    targets: list
    ladder: list = field(default_factory=list)
    full_output: object = None
    reduced_output: object = None
    method: str = "drg"

    def summary(self) -> str:
        red = self.reduction
        return (f"{self.method.upper()}: "
                f"{red.n_reactions}/{red.n_reactions_full} reactions, "
                f"{red.n_species}/{red.n_species_full} species at "
                f"eps={red.eps:.3g} (max target error {self.error:.2e})")


def reduce_network_drg(solvemethod, sd, rd, targets, tol: float = 1e-3,
                       eps_ladder=None, calc=None, n_samples: int = 64,
                       full_output=None, method: str = "drg",
                       device=DEFAULT_DEVICE) -> DRGReductionResult:
    """Error-controlled skeletal reduction of a CRN.

    Solves the full network with ``solvemethod`` (unless ``full_output``
    is supplied), builds the relation graph from its trajectory, then
    walks ``eps_ladder`` (default: 0.3 down to 1e-4, geometric) from the
    most aggressive reduction downward, re-solving each candidate, and
    accepts the FIRST (= smallest) mechanism whose maximum absolute
    deviation on the ``targets``' profiles is <= ``tol``.

    ``method`` selects the graph rule: ``"drg"`` (reachability, Lu &
    Law 2005) or ``"drgep"`` (path-product error propagation,
    Pepiot-Desjardins & Pitsch 2008 — usually smaller mechanisms at the
    same tolerance; see module docstring).

    ``targets`` are species SMILES/labels — the only seed set: anything
    the targets depend on (including initial-composition species) is
    reached through the graph; a trace feed that never influences the
    targets is legitimately dropped (it stays in ``sd`` as an inert).
    Raises if even the full ladder floor cannot meet ``tol``. The solves
    run on ``device``.
    """
    from ..solving.methods import solve_network

    if method not in ("drg", "drgep"):
        raise ValueError(f"method must be 'drg' or 'drgep', got {method!r}")
    if eps_ladder is None:
        eps_ladder = np.geomspace(0.3, 1e-4, 12)
    eps_ladder = sorted((float(e) for e in eps_ladder), reverse=True)

    calc = calc if calc is not None else solvemethod.calculator
    if full_output is None:
        full_output = solve_network(solvemethod, sd, rd, device=device)
    t_full = np.asarray(full_output.sol.t)
    u_full = np.asarray(full_output.sol.u)

    target_ids = [sd.toInt[s] for s in targets]
    seed_ids = set(target_ids)

    if method == "drgep":
        rAB = drgep_adjacency(full_output, calc=calc, n_samples=n_samples)
        R = drgep_coefficients(rAB, sorted(seed_ids))
    else:
        rAB = drg_adjacency(full_output, calc=calc, n_samples=n_samples)

    ladder = []
    for eps in eps_ladder:
        if method == "drgep":
            red = reduce_at_eps_drgep(R, rd, eps)
        else:
            red = reduce_at_eps(rAB, rd, sorted(seed_ids), eps)
        if red.n_reactions == 0:
            ladder.append((eps, red.n_species, 0, float("inf")))
            continue
        if red.n_reactions == rd.nr:
            err = 0.0
            red_out = full_output
        else:
            rd2, calc2 = red.apply(rd, calc)
            method2 = type(solvemethod)(solvemethod.pars,
                                        solvemethod.conditions, calc2)
            red_out = solve_network(method2, sd, rd2, device=device)
            u_red = np.asarray(red_out.sol.u)
            nt = min(u_red.shape[0], u_full.shape[0])
            err = float(np.abs(u_red[:nt, target_ids]
                               - u_full[:nt, target_ids]).max())
        ladder.append((eps, red.n_species, red.n_reactions, err))
        if err <= tol:
            return DRGReductionResult(reduction=red, error=err,
                                      targets=list(targets), ladder=ladder,
                                      full_output=full_output,
                                      reduced_output=red_out,
                                      method=method)
    raise ValueError(
        f"{method.upper()} could not meet tol={tol:g} anywhere on the eps "
        f"ladder (best error {min(l[3] for l in ladder):.3e}); widen the "
        "ladder floor or loosen tol. Ladder: "
        + ", ".join(f"eps={e:.2g}:nr={nr},err={er:.2e}"
                    for e, _, nr, er in ladder))


def reduce_network_drgep(solvemethod, sd, rd, targets, **kwargs
                         ) -> DRGReductionResult:
    """Error-controlled DRGEP reduction — ``reduce_network_drg`` with
    ``method="drgep"``; see that function for the contract."""
    kwargs["method"] = "drgep"
    return reduce_network_drg(solvemethod, sd, rd, targets, **kwargs)
