"""chem-lite molecular graph core: perception, SMILES, isomorphism.

Self-contained replacement for the capabilities the reference obtains from
OpenBabel/RDKit through its Python bridge (SURVEY.md §2.3): geometry ->
connectivity perception, bond-order assignment, fragment splitting,
canonical SMILES generation (implicit-H, radical-aware), SMILES parsing,
molecular weights, and graph isomorphism / atom mapping (networkx VF2).
The real RDKit/OpenBabel are used instead when installed (see
``kinetica_tpu_torch.chem.backends``); chem-lite keeps the whole exploration
pipeline functional without them.

Covers the organic range (H/C/N/O plus halogens, S, P, noble gases).
Aromatic SMILES input is accepted and kekulised on parse; canonical
output emits aromatic (lowercase) SMILES for detected Hückel pi systems
(benzene -> c1ccccc1) and kekulised bonds otherwise, so every Kekulé
form of the same molecule canonicalises identically.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import networkx as nx
import numpy as np

from .elements import (ORGANIC_SUBSET, atomic_mass, covalent_radius,
                       default_valences, vdw_radius)

BOND_TOL = 0.45  # Å beyond covalent-radius sum still counted as bonded
BOND_SYMBOL = {1: "", 2: "=", 3: "#"}


@dataclass
class Molecule:
    """Minimal molecular graph: atoms + integer-order bonds."""
    species: list[str]
    bonds: dict[tuple[int, int], int] = field(default_factory=dict)
    charges: list[int] = field(default_factory=list)
    positions: np.ndarray | None = None

    def __post_init__(self):
        if not self.charges:
            self.charges = [0] * len(self.species)

    @property
    def n_atoms(self) -> int:
        return len(self.species)

    def add_bond(self, i: int, j: int, order: int = 1) -> None:
        self.bonds[(min(i, j), max(i, j))] = order

    def bond_order(self, i: int, j: int) -> int:
        return self.bonds.get((min(i, j), max(i, j)), 0)

    def neighbors(self, i: int) -> list[int]:
        out = []
        for (a, b) in self.bonds:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)

    def total_bond_order(self, i: int) -> int:
        return sum(o for (a, b), o in self.bonds.items() if a == i or b == i)

    def radical_electrons(self, i: int) -> int:
        """Unfilled valence = radical electrons (no charge handling beyond
        simple +/- adjustments)."""
        val = self.total_bond_order(i)
        cands = [v - val - abs(self.charges[i]) for v in default_valences(self.species[i])]
        cands = [c for c in cands if c >= 0]
        return min(cands) if cands else 0

    def to_nx(self) -> nx.Graph:
        g = nx.Graph()
        for i, sym in enumerate(self.species):
            g.add_node(i, element=sym, charge=self.charges[i])
        for (a, b), o in self.bonds.items():
            g.add_edge(a, b, order=o)
        return g

    def molecular_weight(self) -> float:
        return sum(atomic_mass(s) for s in self.species)

    def formula(self) -> str:
        from collections import Counter
        counts = Counter(self.species)
        parts = []
        for sym in ("C", "H"):
            if counts.get(sym):
                n = counts.pop(sym)
                parts.append(sym + (str(n) if n > 1 else ""))
        for sym in sorted(counts):
            n = counts[sym]
            parts.append(sym + (str(n) if n > 1 else ""))
        return "".join(parts)


# ---------------------------------------------------------------------------
# Perception: geometry -> bonds -> bond orders
# ---------------------------------------------------------------------------

def perceive_connectivity(species: list[str], pos: np.ndarray) -> Molecule:
    """Bond i-j when d_ij < r_cov_i + r_cov_j + BOND_TOL (min 0.4 Å).

    Uses the native C++ kernel (csrc/chemlite.cpp) when available; both
    paths implement the identical rule.
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = len(species)
    mol = Molecule(list(species), positions=pos)
    radii = np.array([covalent_radius(s) for s in species])
    from .native import perceive_bonds_native
    pairs = perceive_bonds_native(pos, radii, BOND_TOL)
    if pairs is not None:
        for i, j in pairs:
            mol.add_bond(int(i), int(j), 1)
        return mol
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    cut = radii[:, None] + radii[None, :] + BOND_TOL
    for i in range(n):
        for j in range(i + 1, n):
            if 0.4 < d[i, j] < cut[i, j]:
                mol.add_bond(i, j, 1)
    return mol


def assign_bond_orders(mol: Molecule) -> Molecule:
    """Upgrade single bonds to multiple bonds to satisfy default valences.

    Greedy maximum-matching on the unsaturation graph (repeated, so triple
    bonds emerge as two successive upgrades); leftover unsaturation remains
    as radical electrons — the valence-based analog of the reference's
    OBCanonicalRadicals fix-ups (openbabel/conversion.jl:12-33).
    """
    def unsaturation(i):
        val = mol.total_bond_order(i)
        targets = default_valences(mol.species[i])
        best = min((t for t in targets if t >= val), default=None)
        return 0 if best is None else best - val

    for _ in range(2):  # two passes: double then triple bonds
        g = nx.Graph()
        for (a, b), o in mol.bonds.items():
            ua, ub = unsaturation(a), unsaturation(b)
            if ua > 0 and ub > 0:
                # prefer short bonds when geometry is available
                w = 1.0
                if mol.positions is not None:
                    d = float(np.linalg.norm(mol.positions[a] - mol.positions[b]))
                    expected = covalent_radius(mol.species[a]) + covalent_radius(mol.species[b])
                    w = 1.0 + max(0.0, expected - d)
                g.add_edge(a, b, weight=w)
        if g.number_of_edges() == 0:
            break
        matching = nx.max_weight_matching(g, maxcardinality=True)
        if not matching:
            break
        for a, b in matching:
            mol.add_bond(a, b, mol.bond_order(a, b) + 1)
    return mol


def mol_from_frame(frame) -> Molecule:
    from .xyz import frame_positions, frame_species
    mol = perceive_connectivity(frame_species(frame), frame_positions(frame))
    return assign_bond_orders(mol)


def split_fragments(mol: Molecule) -> list[tuple[Molecule, list[int]]]:
    """Connected components as (fragment molecule, original atom indices)."""
    g = mol.to_nx()
    out = []
    for comp in nx.connected_components(g):
        idx = sorted(comp)
        remap = {orig: k for k, orig in enumerate(idx)}
        frag = Molecule(
            [mol.species[i] for i in idx],
            charges=[mol.charges[i] for i in idx],
            positions=None if mol.positions is None else mol.positions[idx])
        for (a, b), o in mol.bonds.items():
            if a in remap and b in remap:
                frag.add_bond(remap[a], remap[b], o)
        out.append((frag, idx))
    return out


# ---------------------------------------------------------------------------
# Canonical ranking (Morgan refinement) and SMILES output
# ---------------------------------------------------------------------------

def aromatic_system(mol: Molecule) -> set[int]:
    """Atoms of Hückel-aromatic pi systems (Kekulé-invariant membership).

    A pi system is a maximal set of ring atoms (C/N/O/S) each carrying
    EXACTLY ONE double bond, whose double-bond partner is also in the
    set, with every atom on a cycle of the set and 4n+2 pi electrons
    (|set| - 2 divisible by 4 with |set| even: benzene 6, naphthalene
    10; cyclobutadiene 4 and cyclooctatetraene 8 are excluded). Used to
    emit aromatic (lowercase) SMILES and to make canonical ranks
    independent of which Kekulé assignment perception/parsing chose —
    without it, two embeddings of benzene could canonicalise to
    different strings and break SpeciesData dedup."""
    n = mol.n_atoms
    if not mol.bonds:
        return set()
    g = mol.to_nx()
    try:
        ring_atoms = set(nx.k_core(g, 2).nodes)
    except Exception:
        return set()
    cand = set()
    for i in ring_atoms:
        if mol.species[i] not in ("C", "N", "O", "S"):
            continue
        dbl = [j for j in mol.neighbors(i) if mol.bond_order(i, j) == 2]
        if len(dbl) == 1 and dbl[0] in ring_atoms:
            cand.add(i)
    # double-bond partners must both be candidates
    changed = True
    while changed:
        changed = False
        for i in list(cand):
            j = next(k for k in mol.neighbors(i)
                     if mol.bond_order(i, k) == 2)
            if j not in cand:
                cand.discard(i)
                changed = True
    out: set[int] = set()
    sub = g.subgraph(cand)
    for comp in nx.connected_components(sub):
        comp = set(comp)
        # every atom on a cycle within the component (no appendages)
        if set(nx.k_core(sub.subgraph(comp), 2).nodes) != comp:
            continue
        if len(comp) % 2 == 0 and (len(comp) - 2) % 4 == 0:
            out |= comp
            continue
        # Linked/fused systems whose TOTAL atom count is 4n (biphenyl 12,
        # pyrene 16) fail the whole-component count even though every
        # ring is aromatic — decompose into SSSR-style rings and apply
        # the Hückel count per ring instead (r4 advisor finding).
        csub = sub.subgraph(comp)
        try:
            rings = nx.minimum_cycle_basis(csub)
        except Exception:
            continue
        for ring in rings:
            m = len(ring)
            if m % 2 == 0 and (m - 2) % 4 == 0:
                out |= set(ring)
    return out


def _initial_invariants(mol: Molecule) -> np.ndarray:
    """Integer-encoded initial atom invariants, shared by the Python and
    native Morgan implementations (identical ranks guaranteed)."""
    from .elements import atomic_number
    out = np.empty(mol.n_atoms, dtype=np.int64)
    for i in range(mol.n_atoms):
        code = atomic_number(mol.species[i])
        code = code * 64 + len(mol.neighbors(i))
        code = code * 64 + mol.total_bond_order(i)
        code = code * 64 + (mol.charges[i] + 32)
        code = code * 64 + mol.radical_electrons(i)
        out[i] = code
    return out


def canonical_ranks(mol: Molecule) -> list[int]:
    """Deterministic canonical atom ranks via iterative Morgan refinement.

    Dispatches to the native C++ kernel when available; the fallback below
    is the identical algorithm.
    """
    n = mol.n_atoms
    inv_arr = _initial_invariants(mol)
    # Kekulé invariance: within an aromatic pi system the double bonds
    # are an arbitrary perfect matching — rank with those orders
    # uniformised to 1 so every Kekulé form of the same molecule gets
    # identical ranks (atom invariants are already Kekulé-invariant:
    # each aromatic atom carries exactly one double bond).
    arom = aromatic_system(mol)

    def eff_order(i, j, o):
        return 1 if (o == 2 and i in arom and j in arom) else o

    from .native import morgan_ranks_native
    if mol.bonds:
        items = sorted(mol.bonds.items())
        bond_a = np.array([e[0][0] for e in items], dtype=np.int32)
        bond_b = np.array([e[0][1] for e in items], dtype=np.int32)
        bond_o = np.array([eff_order(e[0][0], e[0][1], e[1])
                           for e in items], dtype=np.int32)
    else:
        bond_a = bond_b = bond_o = np.empty(0, dtype=np.int32)
    native = morgan_ranks_native(inv_arr, bond_a, bond_b, bond_o)
    if native is not None:
        return [int(r) for r in native]

    ranks = _ranks_from_keys([int(v) for v in inv_arr])
    for _ in range(2 * n + 2):
        keys = []
        for i in range(n):
            nb = sorted((ranks[j], eff_order(i, j, mol.bond_order(i, j)))
                        for j in mol.neighbors(i))
            keys.append((ranks[i], tuple(nb)))
        new_ranks = _ranks_from_keys(keys)
        if new_ranks == ranks:
            break
        ranks = new_ranks
    # tie-break residual classes deterministically (members are automorphic
    # for molecular graphs at this scale)
    order = sorted(range(n), key=lambda i: (ranks[i], i))
    pos = {atom: p for p, atom in enumerate(order)}
    return [pos[i] for i in range(n)]


def _ranks_from_keys(keys) -> list[int]:
    uniq = sorted(set(keys))
    lookup = {k: r for r, k in enumerate(uniq)}
    return [lookup[k] for k in keys]


def _atom_token(mol: Molecule, i: int, implicit_h: int, mapnum: int | None,
                aromatic: bool = False) -> str:
    sym = mol.species[i]
    charge = mol.charges[i]
    rad = mol.radical_electrons(i) - implicit_h  # rad after folding H? computed by caller
    needs_bracket = (
        mapnum is not None
        or sym not in ORGANIC_SUBSET
        or charge != 0
        or mol.radical_electrons(i) > 0
        or sym == "H")
    if aromatic and len(sym) == 1:
        sym = sym.lower()
    if not needs_bracket:
        return sym
    h_str = "" if implicit_h == 0 else ("H" if implicit_h == 1 else f"H{implicit_h}")
    if charge > 0:
        c_str = "+" if charge == 1 else f"+{charge}"
    elif charge < 0:
        c_str = "-" if charge == -1 else f"-{abs(charge)}"
    else:
        c_str = ""
    m_str = "" if mapnum is None else f":{mapnum}"
    return f"[{sym}{h_str}{c_str}{m_str}]"


def to_smiles(mol: Molecule, canonical: bool = True,
              map_numbers: list[int] | None = None) -> str:
    """Write (canonical) SMILES. With ``map_numbers``, every atom (including
    hydrogens) is emitted explicitly with its map index — the form the
    reference's ``atom_map_smiles`` produces (rdkit.jl:87-127)."""
    n = mol.n_atoms
    if n == 0:
        return ""
    mapped = map_numbers is not None

    # fold hydrogens into heavy atoms unless mapping explicitly
    fold_h: dict[int, int] = {}
    skip: set[int] = set()
    if not mapped:
        for i in range(n):
            if mol.species[i] != "H":
                continue
            nbrs = mol.neighbors(i)
            if len(nbrs) == 1 and mol.species[nbrs[0]] != "H" and mol.charges[i] == 0:
                fold_h[nbrs[0]] = fold_h.get(nbrs[0], 0) + 1
                skip.add(i)

    ranks = canonical_ranks(mol) if canonical else list(range(n))
    arom = aromatic_system(mol)

    def bond_sym(a, b):
        o = mol.bond_order(a, b)
        if o == 2 and a in arom and b in arom:
            return ""           # aromatic bond: implied
        return BOND_SYMBOL.get(o, "")

    # One deterministic DFS per component produces the spanning tree
    # (children in canonical-rank order) and the ring-closure bonds.
    children: dict[int, list[int]] = {i: [] for i in range(n)}
    ring_bonds: dict[tuple[int, int], int] = {}
    ring_counter = [0]
    visited: set[int] = set()

    def dfs(root):
        stack = [(root, -1)]
        while stack:
            node, parent = stack.pop()
            if node in visited:
                continue
            visited.add(node)
            nbrs = sorted((j for j in mol.neighbors(node) if j not in skip),
                          key=lambda j: ranks[j], reverse=True)
            for nb in nbrs:
                if nb == parent:
                    continue
                e = (min(node, nb), max(node, nb))
                if nb in visited:
                    if e not in ring_bonds and node not in children.get(nb, []):
                        ring_counter[0] += 1
                        ring_bonds[e] = ring_counter[0]
                else:
                    stack.append((nb, node))
        # build children lists from visit structure: re-walk tree edges
        # (an edge is a tree edge iff not a ring bond)

    # determine components and roots
    comp_roots = []
    for comp in nx.connected_components(mol.to_nx()):
        atoms = [i for i in comp if i not in skip]
        if not atoms:
            atoms = sorted(comp)
        comp_roots.append(min(atoms, key=lambda i: ranks[i]))

    for root in sorted(comp_roots, key=lambda r: ranks[r]):
        dfs(root)

    # recursive emission following canonical child order, tree edges only
    import sys
    sys.setrecursionlimit(max(10000, 10 * n))
    emitted: set[int] = set()

    def emit(node, parent):
        emitted.add(node)
        implicit = fold_h.get(node, 0)
        mapnum = map_numbers[node] if mapped else None
        frag = [_atom_token(mol, node, implicit, mapnum,
                            aromatic=node in arom)]
        for e, num in sorted(ring_bonds.items(), key=lambda kv: kv[1]):
            if node in e:
                other = e[0] if e[1] == node else e[1]
                b = bond_sym(node, other)
                digit = f"{num}" if num < 10 else f"%{num}"
                frag.append(f"{b}{digit}" if other not in emitted else digit)
        kids = [j for j in sorted(
            (j for j in mol.neighbors(node) if j not in skip),
            key=lambda j: ranks[j])
            if j != parent and j not in emitted
            and (min(node, j), max(node, j)) not in ring_bonds]
        for idx, child in enumerate(kids):
            b = bond_sym(node, child)
            sub = emit(child, node)
            frag.append(f"({b}{sub})" if idx < len(kids) - 1 else f"{b}{sub}")
        return "".join(frag)

    return ".".join(emit(root, -1)
                    for root in sorted(comp_roots, key=lambda r: ranks[r]))


# ---------------------------------------------------------------------------
# SMILES parsing
# ---------------------------------------------------------------------------

_BRACKET_RE = re.compile(
    r"\[(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[cnosp])(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,2}|-{1,2}|\+\d+|-\d+)?(?::(?P<map>\d+))?\]")

_ORGANIC_RE = re.compile(r"Cl|Br|[BCNOPSFI]|[cnosb]")


def from_smiles(smiles: str, add_implicit_h: bool = True) -> Molecule:
    """Parse a SMILES string (organic subset + brackets + rings + branches).

    Implicit hydrogens are instantiated as explicit H atoms (the reference
    parses with explicit H too, Kinetica.jl:69-72). Aromatic lowercase atoms
    are accepted and treated as sp2 with alternating bonds via the
    bond-order matcher.
    """
    mol = Molecule([])
    mol.charges = []
    prev: list[int | None] = [None]
    pending_bond = [1]
    ring_open: dict[int, tuple[int, int]] = {}
    stack: list[int | None] = []
    h_requests: dict[int, int] = {}
    map_numbers: dict[int, int] = {}
    aromatic_atoms: set[int] = set()

    def add_atom(sym, h_count=None, charge=0, mapnum=None, aromatic=False):
        idx = mol.n_atoms
        mol.species.append(sym)
        mol.charges.append(charge)
        if h_count is not None:
            h_requests[idx] = h_count
        if mapnum is not None:
            map_numbers[idx] = mapnum
        if aromatic:
            aromatic_atoms.add(idx)
        if prev[0] is not None and pending_bond[0] > 0:
            mol.add_bond(prev[0], idx, pending_bond[0])
        prev[0] = idx
        pending_bond[0] = 1
        return idx

    i = 0
    while i < len(smiles):
        ch = smiles[i]
        if ch == "[":
            m = _BRACKET_RE.match(smiles, i)
            if not m:
                raise ValueError(f"Bad bracket atom in SMILES at {i}: {smiles}")
            sym = m.group("symbol")
            aromatic = sym.islower()
            sym = sym.capitalize() if aromatic else sym
            h = m.group("hcount")
            h_count = 0 if h is None else (1 if h == "H" else int(h[1:]))
            c = m.group("charge") or ""
            if c in ("+", "++"):
                charge = len(c)
            elif c in ("-", "--"):
                charge = -len(c)
            elif c:
                charge = int(c)
            else:
                charge = 0
            mapnum = int(m.group("map")) if m.group("map") else None
            add_atom(sym, h_count, charge, mapnum, aromatic)
            i = m.end()
        elif ch in "-=#:/\\":
            pending_bond[0] = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1}[ch]
            i += 1
        elif ch == "(":
            stack.append(prev[0])
            i += 1
        elif ch == ")":
            prev[0] = stack.pop()
            i += 1
        elif ch == ".":
            prev[0] = None
            pending_bond[0] = 0
            i += 1
            pending_bond[0] = 1
            prev[0] = None
        elif ch == "%":
            num = int(smiles[i + 1: i + 3])
            _ring(num, prev, pending_bond, ring_open, mol)
            i += 3
        elif ch.isdigit():
            _ring(int(ch), prev, pending_bond, ring_open, mol)
            i += 1
        else:
            m = _ORGANIC_RE.match(smiles, i)
            if not m:
                raise ValueError(f"Unparsable SMILES at {i}: {smiles}")
            tok = m.group(0)
            aromatic = tok.islower()
            add_atom(tok.capitalize() if aromatic else tok,
                     None, 0, None, aromatic)
            i = m.end()

    if ring_open:
        raise ValueError(f"Unclosed ring bonds in SMILES: {smiles}")

    # instantiate hydrogens
    if add_implicit_h:
        n_heavy = mol.n_atoms
        for idx in range(n_heavy):
            sym = mol.species[idx]
            if sym == "H":
                continue
            if idx in h_requests:
                n_h = h_requests[idx]
            else:
                # organic-subset atom: fill to lowest standard valence
                val = mol.total_bond_order(idx)
                if idx in aromatic_atoms:
                    val += 1  # aromatic atoms get one extra implied bond
                targets = [v for v in default_valences(sym) if v >= val]
                n_h = (targets[0] - val) if targets else 0
            for _ in range(n_h):
                h_idx = mol.n_atoms
                mol.species.append("H")
                mol.charges.append(0)
                mol.add_bond(idx, h_idx, 1)
    # kekulise aromatic rings: alternate double bonds along
    # aromatic-aromatic edges via maximum matching
    if aromatic_atoms:
        g = nx.Graph()
        for (a, b), o in mol.bonds.items():
            if a in aromatic_atoms and b in aromatic_atoms and o == 1:
                g.add_edge(a, b)
        for a, b in nx.max_weight_matching(g, maxcardinality=True):
            mol.add_bond(a, b, 2)

    mol._map_numbers = map_numbers  # type: ignore[attr-defined]
    return mol


def _ring(num, prev, pending_bond, ring_open, mol):
    if num in ring_open:
        j, order = ring_open.pop(num)
        mol.add_bond(prev[0], j, max(order, pending_bond[0]))
    else:
        ring_open[num] = (prev[0], pending_bond[0])
    pending_bond[0] = 1


# ---------------------------------------------------------------------------
# Isomorphism / atom mapping
# ---------------------------------------------------------------------------

def _nx_match_graphs(m1: Molecule, m2: Molecule, use_order: bool = True):
    nm = nx.algorithms.isomorphism.categorical_node_match("element", None)
    em = (nx.algorithms.isomorphism.categorical_edge_match("order", 1)
          if use_order else None)
    return nx.algorithms.isomorphism.GraphMatcher(
        m1.to_nx(), m2.to_nx(), node_match=nm, edge_match=em)


def is_isomorphic(m1: Molecule, m2: Molecule, use_order: bool = True) -> bool:
    if sorted(m1.species) != sorted(m2.species):
        return False
    return _nx_match_graphs(m1, m2, use_order).is_isomorphic()


def find_isomorphism(m1: Molecule, m2: Molecule,
                     use_order: bool = True) -> dict[int, int] | None:
    """Atom index map m1 -> m2, or None."""
    gm = _nx_match_graphs(m1, m2, use_order)
    if gm.is_isomorphic():
        return dict(gm.mapping)
    # fall back to connectivity-only match (bond orders may differ between
    # perception runs)
    gm2 = _nx_match_graphs(m1, m2, use_order=False)
    if gm2.is_isomorphic():
        return dict(gm2.mapping)
    return None
