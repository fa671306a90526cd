// chem-lite native kernels: bond perception and Morgan canonical ranking.
//
// The exploration ingestion hot path (every CDE run -> connectivity
// perception -> fragment SMILES canonicalisation, cde.jl:258-316 in the
// reference) is host-side work this framework implements first-party.
// These kernels replace the O(N^2) Python loops; loaded via ctypes with a
// pure-Python fallback (kinetica_tpu/chem/native.py).
//
// Build: g++ -O3 -shared -fPIC -o libchemlite.so chemlite.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <utility>
#include <vector>

extern "C" {

// Bond perception: pair (i, j) bonded when
//   0.4 < dist(i, j) < r_cov[i] + r_cov[j] + tol.
// Writes up to max_pairs (i, j) index pairs into out_pairs (row-major).
// Returns the number of bonds found (may exceed max_pairs; caller should
// retry with a larger buffer in that case).
int chemlite_perceive_bonds(const double* pos, const double* radii, int n,
                            double tol, int32_t* out_pairs, int max_pairs) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    for (int j = i + 1; j < n; ++j) {
      const double dx = pos[3 * j] - xi;
      const double dy = pos[3 * j + 1] - yi;
      const double dz = pos[3 * j + 2] - zi;
      const double d2 = dx * dx + dy * dy + dz * dz;
      const double cut = radii[i] + radii[j] + tol;
      if (d2 < cut * cut && d2 > 0.16) {
        if (count < max_pairs) {
          out_pairs[2 * count] = i;
          out_pairs[2 * count + 1] = j;
        }
        ++count;
      }
    }
  }
  return count;
}

// Morgan canonical ranking by iterative refinement.
//
// init_inv: per-atom initial invariant (already encoded as an integer by
// the caller: element/degree/valence/charge/radicals). bond_a/bond_b/
// bond_order: edge list. out_ranks: final 0-based canonical ranks,
// deterministically tie-broken by (rank history, atom index).
void chemlite_morgan_ranks(int n_atoms, const int64_t* init_inv, int n_bonds,
                           const int32_t* bond_a, const int32_t* bond_b,
                           const int32_t* bond_order, int32_t* out_ranks) {
  std::vector<std::vector<std::pair<int, int>>> nbrs(n_atoms);
  for (int e = 0; e < n_bonds; ++e) {
    nbrs[bond_a[e]].push_back({bond_b[e], bond_order[e]});
    nbrs[bond_b[e]].push_back({bond_a[e], bond_order[e]});
  }

  // initial ranks from invariants
  std::vector<int> ranks(n_atoms);
  {
    std::vector<std::pair<int64_t, int>> keyed(n_atoms);
    for (int i = 0; i < n_atoms; ++i) keyed[i] = {init_inv[i], i};
    std::sort(keyed.begin(), keyed.end());
    int r = -1;
    int64_t prev = 0;
    bool first = true;
    for (auto& kv : keyed) {
      if (first || kv.first != prev) { ++r; prev = kv.first; first = false; }
      ranks[kv.second] = r;
    }
  }

  using Key = std::pair<int, std::vector<std::pair<int, int>>>;
  for (int iter = 0; iter < 2 * n_atoms + 2; ++iter) {
    std::vector<Key> keys(n_atoms);
    for (int i = 0; i < n_atoms; ++i) {
      std::vector<std::pair<int, int>> nb;
      nb.reserve(nbrs[i].size());
      for (auto& p : nbrs[i]) nb.push_back({ranks[p.first], p.second});
      std::sort(nb.begin(), nb.end());
      keys[i] = {ranks[i], std::move(nb)};
    }
    std::map<Key, int> lookup;
    for (auto& k : keys) lookup.emplace(k, 0);
    int r = 0;
    for (auto& kv : lookup) kv.second = r++;
    std::vector<int> new_ranks(n_atoms);
    for (int i = 0; i < n_atoms; ++i) new_ranks[i] = lookup[keys[i]];
    if (new_ranks == ranks) break;
    ranks.swap(new_ranks);
  }

  // final total order: (rank, index)
  std::vector<std::pair<std::pair<int, int>, int>> order(n_atoms);
  for (int i = 0; i < n_atoms; ++i) order[i] = {{ranks[i], i}, i};
  std::sort(order.begin(), order.end());
  for (int p = 0; p < n_atoms; ++p) out_ranks[order[p].second] = p;
}

}  // extern "C"
