// cde_lite: native graph-driven reaction mechanism sampler.
//
// A first-party, self-contained C++ replacement for the capability of the
// external Fortran CDE binary the reference orchestrates
// (/root/reference/src/exploration/cde.jl:54-122; template contract at
// examples/cde_template/input). NOT a port: CDE drives xTB quantum
// chemistry; cde_lite samples the same *graph move* space (curated
// movefile patterns or built-in break/form/transfer moves, valence-range
// constrained) and generates product geometries with a classical
// bond-harmonic + soft-repulsion relaxation, so the whole exploration
// stack (runner -> ingest -> CRN -> kinetic gating) runs end-to-end with
// zero external dependencies. Plug a real CDE/xTB in by pointing
// CDE(cde_exec=...) at the real binary instead.
//
// File contract (what the runner writes/reads):
//   reads  ./input      keys: nmcrxn N, nrxn M, ranseed S, startfile F,
//                        movefile F, valencerange{...}, reactiveatomtypes{...}
//   reads  ./Start.xyz  seed geometry (possibly multi-molecule)
//   writes ./rxn_%04d_step_0001.xyz   2 frames (reactant, product),
//                        comment line "energy=<eV>"
//   writes ./input.log  "finished" on success; contains "ERROR" on failure
//
// Build: g++ -O3 -o cde_lite cde_lite.cpp
#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <functional>
#include <map>
#include <random>
#include <set>
#include <sstream>
#include <string>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------- elements
struct ElementInfo {
  double r_cov;    // covalent radius, Angstrom
  int max_val;     // default maximum valence
  double bde;      // generic homolytic bond energy to anything, eV
};

const std::map<std::string, ElementInfo>& element_table() {
  static const std::map<std::string, ElementInfo> t = {
      {"H", {0.31, 1, 4.2}},  {"C", {0.76, 4, 3.8}},  {"N", {0.71, 3, 3.5}},
      {"O", {0.66, 2, 3.7}},  {"F", {0.57, 1, 4.1}},  {"S", {1.05, 2, 3.0}},
      {"P", {1.07, 3, 3.1}},  {"Cl", {1.02, 1, 3.5}}, {"Br", {1.20, 1, 3.0}},
      {"I", {1.39, 1, 2.6}},  {"Si", {1.11, 4, 3.2}}, {"B", {0.84, 3, 3.4}},
  };
  return t;
}

ElementInfo elem(const std::string& s) {
  auto it = element_table().find(s);
  if (it != element_table().end()) return it->second;
  return {1.0, 4, 3.0};
}

// ---------------------------------------------------------------- xyz I/O
struct Frame {
  std::vector<std::string> species;
  std::vector<double> pos;  // 3N
};

bool read_xyz(const std::string& path, Frame* out) {
  std::ifstream fh(path);
  if (!fh) return false;
  int n = 0;
  if (!(fh >> n)) return false;
  std::string line;
  std::getline(fh, line);          // rest of count line
  std::getline(fh, line);          // comment
  out->species.resize(n);
  out->pos.resize(3 * n);
  for (int i = 0; i < n; ++i) {
    if (!(fh >> out->species[i] >> out->pos[3 * i] >> out->pos[3 * i + 1] >>
          out->pos[3 * i + 2]))
      return false;
  }
  return true;
}

void append_xyz(std::ofstream& fh, const Frame& f, double energy) {
  fh << f.species.size() << "\n";
  char buf[64];
  std::snprintf(buf, sizeof buf, "energy=%.6f", energy);
  fh << buf << "\n";
  for (size_t i = 0; i < f.species.size(); ++i) {
    std::snprintf(buf, sizeof buf, " %14.8f %14.8f %14.8f", f.pos[3 * i],
                  f.pos[3 * i + 1], f.pos[3 * i + 2]);
    fh << f.species[i] << buf << "\n";
  }
}

// ---------------------------------------------------------------- input
struct MovePattern {
  int natom = 0;
  std::vector<int> before;  // natom*natom adjacency
  std::vector<int> after;
  std::vector<std::string> labels;  // "*" = any element
  double prob = 1.0;
};

struct Config {
  int nmcrxn = 1;
  int nrxn = 1;
  unsigned ranseed = 1;
  std::string startfile = "Start.xyz";
  std::string movefile;
  std::map<std::string, std::pair<int, int>> valence_range;  // elem -> (min,max)
  std::set<std::string> reactive_types;  // empty = all
  std::vector<MovePattern> moves;
};

std::string strip(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r\n");
  return s.substr(a, b - a + 1);
}

// Parse the CDE input file: "key value" lines plus "name{ ... }" blocks.
bool parse_input(const std::string& path, Config* cfg) {
  std::ifstream fh(path);
  if (!fh) return false;
  std::string line;
  while (std::getline(fh, line)) {
    size_t bang = line.find('!');
    if (bang != std::string::npos) line = line.substr(0, bang);
    size_t hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    line = strip(line);
    if (line.empty()) continue;
    if (line.back() == '{') {
      std::string block = strip(line.substr(0, line.size() - 1));
      std::vector<std::string> rows;
      while (std::getline(fh, line)) {
        line = strip(line);
        if (line == "}") break;
        if (!line.empty()) rows.push_back(line);
      }
      if (block == "valencerange") {
        for (auto& r : rows) {
          std::istringstream is(r);
          std::string el;
          int lo, hi;
          if (is >> el >> lo >> hi) cfg->valence_range[el] = {lo, hi};
        }
      } else if (block == "reactiveatomtypes") {
        for (auto& r : rows) cfg->reactive_types.insert(strip(r));
      }
      continue;
    }
    std::istringstream is(line);
    std::string key;
    is >> key;
    if (key == "nmcrxn") is >> cfg->nmcrxn;
    else if (key == "nrxn") is >> cfg->nrxn;
    else if (key == "ranseed") is >> cfg->ranseed;
    else if (key == "startfile") is >> cfg->startfile;
    else if (key == "movefile") is >> cfg->movefile;
  }
  return true;
}

// Parse a CDE movefile: "move" blocks with natom, before/after adjacency
// separated by "-" lines, "labels", "prob" (examples/cde_template/moves_2+3.in).
void parse_movefile(const std::string& path, std::vector<MovePattern>* moves) {
  std::ifstream fh(path);
  if (!fh) return;
  std::string line;
  MovePattern cur;
  int section = -1;  // 0: before rows, 1: after rows
  int rows_read = 0;
  bool in_move = false;
  auto flush = [&]() {
    if (in_move && cur.natom > 0 &&
        (int)cur.before.size() == cur.natom * cur.natom &&
        (int)cur.after.size() == cur.natom * cur.natom)
      moves->push_back(cur);
    cur = MovePattern();
    section = -1;
    rows_read = 0;
  };
  while (std::getline(fh, line)) {
    size_t hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    line = strip(line);
    if (line.empty()) continue;
    std::istringstream is(line);
    std::string key;
    is >> key;
    if (key == "move") {
      flush();
      in_move = true;
    } else if (key == "natom") {
      is >> cur.natom;
    } else if (key == "-") {
      ++section;
      rows_read = 0;
    } else if (key == "labels") {
      std::string l;
      while (is >> l) cur.labels.push_back(l);
    } else if (key == "prob") {
      is >> cur.prob;
    } else if (section == 0 || section == 1) {
      // adjacency row: natom integers (first token already consumed)
      std::vector<int>& dst = section == 0 ? cur.before : cur.after;
      dst.push_back(std::atoi(key.c_str()));
      int v;
      while (is >> v) dst.push_back(v);
      ++rows_read;
    }
  }
  flush();
}

// Built-in generic move set when no movefile exists: single bond break,
// single bond form, and atom transfer (break A-B, form B-C).
std::vector<MovePattern> builtin_moves() {
  std::vector<MovePattern> mv;
  MovePattern brk;
  brk.natom = 2;
  brk.before = {0, 1, 1, 0};
  brk.after = {0, 0, 0, 0};
  brk.labels = {"*", "*"};
  brk.prob = 0.35;
  mv.push_back(brk);
  MovePattern form;
  form.natom = 2;
  form.before = {0, 0, 0, 0};
  form.after = {0, 1, 1, 0};
  form.labels = {"*", "*"};
  form.prob = 0.35;
  mv.push_back(form);
  MovePattern xfer;  // A-B / C -> A / B-C
  xfer.natom = 3;
  xfer.before = {0, 1, 0, 1, 0, 0, 0, 0, 0};
  xfer.after = {0, 0, 0, 0, 0, 1, 0, 1, 0};
  xfer.labels = {"*", "*", "*"};
  xfer.prob = 0.3;
  mv.push_back(xfer);
  return mv;
}

// ---------------------------------------------------------------- graph
struct Graph {
  int n = 0;
  std::vector<int> adj;  // n*n, 0/1
  int& at(int i, int j) { return adj[i * n + j]; }
  int cat(int i, int j) const { return adj[i * n + j]; }
  int valence(int i) const {
    int v = 0;
    for (int j = 0; j < n; ++j) v += cat(i, j);
    return v;
  }
};

Graph perceive(const Frame& f, double tol = 0.45) {
  Graph g;
  g.n = (int)f.species.size();
  g.adj.assign(g.n * g.n, 0);
  for (int i = 0; i < g.n; ++i)
    for (int j = i + 1; j < g.n; ++j) {
      double dx = f.pos[3 * i] - f.pos[3 * j];
      double dy = f.pos[3 * i + 1] - f.pos[3 * j + 1];
      double dz = f.pos[3 * i + 2] - f.pos[3 * j + 2];
      double d2 = dx * dx + dy * dy + dz * dz;
      double cut = elem(f.species[i]).r_cov + elem(f.species[j]).r_cov + tol;
      if (d2 < cut * cut && d2 > 0.16) g.at(i, j) = g.at(j, i) = 1;
    }
  return g;
}

std::vector<int> components(const Graph& g) {
  std::vector<int> comp(g.n, -1);
  int c = 0;
  for (int s = 0; s < g.n; ++s) {
    if (comp[s] >= 0) continue;
    std::vector<int> stack = {s};
    comp[s] = c;
    while (!stack.empty()) {
      int i = stack.back();
      stack.pop_back();
      for (int j = 0; j < g.n; ++j)
        if (g.cat(i, j) && comp[j] < 0) {
          comp[j] = c;
          stack.push_back(j);
        }
    }
    ++c;
  }
  return comp;
}

// Enumerate ordered tuples of distinct atoms matching a move's *before*
// adjacency and element labels; tuples are capped to keep this O(matches).
void find_matches(const Graph& g, const Frame& f, const MovePattern& mv,
                  const std::set<std::string>& reactive,
                  std::vector<std::vector<int>>* out, size_t cap = 4096) {
  int m = mv.natom;
  std::vector<int> tuple(m, -1);
  std::vector<char> used(g.n, 0);
  std::function<void(int)> rec = [&](int depth) {
    if (out->size() >= cap) return;
    if (depth == m) {
      out->push_back(tuple);
      return;
    }
    for (int a = 0; a < g.n; ++a) {
      if (used[a]) continue;
      if (!reactive.empty() && !reactive.count(f.species[a])) continue;
      if (depth < (int)mv.labels.size() && mv.labels[depth] != "*" &&
          mv.labels[depth] != f.species[a])
        continue;
      bool ok = true;
      for (int p = 0; p < depth && ok; ++p)
        if (g.cat(tuple[p], a) != mv.before[p * m + depth]) ok = false;
      if (!ok) continue;
      tuple[depth] = a;
      used[a] = 1;
      rec(depth + 1);
      used[a] = 0;
    }
  };
  rec(0);
}

bool valences_ok(const Graph& g, const Frame& f, const Config& cfg) {
  for (int i = 0; i < g.n; ++i) {
    int v = g.valence(i);
    auto it = cfg.valence_range.find(f.species[i]);
    int lo = 0, hi = elem(f.species[i]).max_val;
    if (it != cfg.valence_range.end()) {
      lo = it->second.first;
      hi = it->second.second;
    }
    if (v < lo || v > hi) return false;
  }
  return true;
}

// ---------------------------------------------------------------- geometry
// Damped gradient relaxation on V = sum_bonds k(r-r0)^2 + soft repulsion
// between nonbonded atoms (the classical stand-in for CDE's gdsrelax
// graph-driven structure generation, template keys ngdsrelax/gdsdtrelax).
void relax(Frame* f, const Graph& g, int iters = 800, double step0 = 0.02) {
  int n = g.n;
  std::vector<double> grad(3 * n);
  double step = step0;
  double prev_v = 1e300;
  for (int it = 0; it < iters; ++it) {
    std::fill(grad.begin(), grad.end(), 0.0);
    double V = 0.0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) {
        double dx = f->pos[3 * i] - f->pos[3 * j];
        double dy = f->pos[3 * i + 1] - f->pos[3 * j + 1];
        double dz = f->pos[3 * i + 2] - f->pos[3 * j + 2];
        double r = std::sqrt(dx * dx + dy * dy + dz * dz) + 1e-12;
        double fmag = 0.0;
        if (g.cat(i, j)) {
          double r0 = elem(f->species[i]).r_cov + elem(f->species[j]).r_cov;
          V += 10.0 * (r - r0) * (r - r0);
          fmag = 2.0 * 10.0 * (r - r0);  // d/dr
        } else {
          double r0 = 1.2 * (elem(f->species[i]).r_cov +
                             elem(f->species[j]).r_cov);
          if (r < r0) {
            double d = r0 - r;
            V += 8.0 * d * d;
            fmag = -2.0 * 8.0 * d;
          }
        }
        double gx = fmag * dx / r, gy = fmag * dy / r, gz = fmag * dz / r;
        grad[3 * i] += gx;
        grad[3 * i + 1] += gy;
        grad[3 * i + 2] += gz;
        grad[3 * j] -= gx;
        grad[3 * j + 1] -= gy;
        grad[3 * j + 2] -= gz;
      }
    if (V > prev_v) step *= 0.5;
    else step = std::min(step * 1.05, 0.1);
    prev_v = V;
    double gmax = 0.0;
    for (double gv : grad) gmax = std::max(gmax, std::fabs(gv));
    if (gmax < 1e-4) break;
    double scale = step / std::max(1.0, gmax);
    for (int i = 0; i < 3 * n; ++i) f->pos[i] -= scale * grad[i];
  }
}

// Pull newly-bonded fragments near each other before relaxing; push
// separated fragments apart afterwards so connectivity perception on the
// product matches its graph.
void place_components(Frame* f, const Graph& g) {
  std::vector<int> comp = components(g);
  int nc = 1 + *std::max_element(comp.begin(), comp.end());
  if (nc <= 1) return;
  // center each component, then spread on a coarse 3D lattice 20 A apart
  std::vector<std::array<double, 3>> com(nc, {0, 0, 0});
  std::vector<int> cnt(nc, 0);
  for (int i = 0; i < g.n; ++i) {
    for (int d = 0; d < 3; ++d) com[comp[i]][d] += f->pos[3 * i + d];
    ++cnt[comp[i]];
  }
  for (int c = 0; c < nc; ++c)
    for (int d = 0; d < 3; ++d) com[c][d] /= std::max(cnt[c], 1);
  for (int i = 0; i < g.n; ++i) {
    int c = comp[i];
    double tx = 22.0 * (c % 3), ty = 22.0 * ((c / 3) % 3), tz = 22.0 * (c / 9);
    f->pos[3 * i] += tx - com[c][0];
    f->pos[3 * i + 1] += ty - com[c][1];
    f->pos[3 * i + 2] += tz - com[c][2];
  }
}

double frame_energy(const Frame& f, const Graph& g) {
  double e = 0.0;
  for (int i = 0; i < g.n; ++i)
    for (int j = i + 1; j < g.n; ++j)
      if (g.cat(i, j))
        e -= 0.5 * (elem(f.species[i]).bde + elem(f.species[j]).bde);
  return e;
}

}  // namespace

int main(int argc, char** argv) {
  // CDE convention: `cde_exec input` with the input file in cwd
  // (reference cde.jl:81-84). A directory argument switches cwd instead.
  std::string input_file = "input";
  if (argc > 1 && std::strcmp(argv[1], "--help") != 0) {
    std::ifstream probe(argv[1]);
    if (probe.good()) {
      input_file = argv[1];
    } else if (chdir(argv[1]) != 0) {
      std::ofstream("input.log") << "ERROR: cannot open " << argv[1] << "\n";
      return 1;
    }
  }
  Config cfg;
  if (!parse_input(input_file, &cfg)) {
    std::ofstream("input.log") << "ERROR: missing input file\n";
    return 1;
  }
  Frame start;
  if (!read_xyz(cfg.startfile, &start)) {
    std::ofstream("input.log") << "ERROR: cannot read " << cfg.startfile << "\n";
    return 1;
  }
  if (!cfg.movefile.empty()) parse_movefile(cfg.movefile, &cfg.moves);
  if (cfg.moves.empty()) cfg.moves = builtin_moves();

  std::mt19937 rng(cfg.ranseed);
  Graph g0 = perceive(start);
  int written = 0;
  std::ostringstream log;

  for (int mech = 0; mech < std::max(cfg.nmcrxn, 1); ++mech) {
    Frame reac = start;
    Graph g = g0;
    Graph gp = g;
    bool changed = false;
    // apply nrxn graph moves (a "mechanism" in CDE terms)
    for (int stepi = 0; stepi < std::max(cfg.nrxn, 1); ++stepi) {
      // weighted move selection with rejection: up to 50 attempts
      double ptot = 0.0;
      for (auto& m : cfg.moves) ptot += m.prob;
      bool applied = false;
      for (int attempt = 0; attempt < 50 && !applied; ++attempt) {
        double x = std::uniform_real_distribution<>(0.0, ptot)(rng);
        const MovePattern* mv = &cfg.moves.back();
        for (auto& m : cfg.moves) {
          if (x < m.prob) { mv = &m; break; }
          x -= m.prob;
        }
        std::vector<std::vector<int>> matches;
        find_matches(gp, reac, *mv, cfg.reactive_types, &matches);
        if (matches.empty()) continue;
        auto& tup =
            matches[std::uniform_int_distribution<size_t>(0, matches.size() - 1)(rng)];
        Graph trial = gp;
        int m = mv->natom;
        for (int a = 0; a < m; ++a)
          for (int b = 0; b < m; ++b)
            trial.at(tup[a], tup[b]) = mv->after[a * m + b];
        if (!valences_ok(trial, reac, cfg)) continue;
        bool same = trial.adj == gp.adj;
        if (same) continue;
        gp = trial;
        applied = true;
      }
      changed |= applied;
    }
    if (!changed || gp.adj == g.adj) {
      log << "mechanism " << mech + 1 << ": no graph change, skipped\n";
      continue;
    }
    // Restrict frames to the reacting subsystem: components (in the union
    // of reactant+product graphs) containing a changed edge. The real CDE
    // likewise emits only the active molecules, so spectator seed
    // molecules never inflate reaction molecularity.
    {
      Graph gu = g;
      for (int i = 0; i < g.n * g.n; ++i)
        gu.adj[i] = g.adj[i] | gp.adj[i];
      std::vector<int> ucomp = components(gu);
      std::set<int> active_comps;
      for (int i = 0; i < g.n; ++i)
        for (int j = i + 1; j < g.n; ++j)
          if (g.cat(i, j) != gp.cat(i, j)) {
            active_comps.insert(ucomp[i]);
            active_comps.insert(ucomp[j]);
          }
      std::vector<int> keep;
      for (int i = 0; i < g.n; ++i)
        if (active_comps.count(ucomp[i])) keep.push_back(i);
      if ((int)keep.size() < g.n) {
        Frame sub;
        Graph sg, sgp;
        sg.n = sgp.n = (int)keep.size();
        sg.adj.assign(sg.n * sg.n, 0);
        sgp.adj.assign(sg.n * sg.n, 0);
        for (size_t a = 0; a < keep.size(); ++a) {
          sub.species.push_back(reac.species[keep[a]]);
          for (int d = 0; d < 3; ++d)
            sub.pos.push_back(reac.pos[3 * keep[a] + d]);
          for (size_t b = 0; b < keep.size(); ++b) {
            sg.at(a, b) = g.cat(keep[a], keep[b]);
            sgp.at(a, b) = gp.cat(keep[a], keep[b]);
          }
        }
        reac = sub;
        g = sg;
        gp = sgp;
      }
    }
    // product geometry: place fragments, relax on the product graph
    Frame prod = reac;
    place_components(&prod, gp);
    relax(&prod, gp);
    place_components(&prod, gp);  // re-separate after relax drift

    // verify perceived connectivity of the generated geometry matches gp
    Graph gv = perceive(prod);
    if (gv.adj != gp.adj) {
      relax(&prod, gp, 2000, 0.01);
      place_components(&prod, gp);
      gv = perceive(prod);
      if (gv.adj != gp.adj) {
        log << "mechanism " << mech + 1 << ": geometry generation failed\n";
        continue;
      }
    }
    char name[64];
    std::snprintf(name, sizeof name, "rxn_%04d_step_0001.xyz", ++written);
    std::ofstream out(name);
    append_xyz(out, reac, frame_energy(reac, g));
    append_xyz(out, prod, frame_energy(prod, gp));
    log << "mechanism " << mech + 1 << ": wrote " << name << "\n";
  }

  std::ofstream lg("input.log");
  if (written == 0) {
    lg << log.str() << "ERROR: no mechanisms generated\n";
    return 1;
  }
  lg << log.str() << "cde_lite finished OK (" << written << " mechanisms)\n";
  return 0;
}
