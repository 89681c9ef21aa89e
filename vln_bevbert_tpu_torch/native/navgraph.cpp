// Native nav-graph engine.
//
// Host-side C++ for the graph math on the fine-tuning hot path — the role the
// reference delegates to external native deps (MatterSim's C++ graph state
// machine; SURVEY.md L0) plus the per-step Python Floyd-Warshall relaxation
// in GraphMap (reference map_nav_src/models/graph_utils.py:63-72),
// which is O(n^2) Python dict work per visited node per rollout step.
//
// Two engines, exposed through a C ABI for ctypes:
//   * StaticGraph  — all-pairs Dijkstra over a full scan graph
//                    (ref load_nav_graphs, pretrain_src/data/common.py:71-103)
//   * FloydEngine  — incremental all-pairs shortest paths over the explored
//                    subgraph with midpoint tracking for path reconstruction
//                    (ref FloydGraph, graph_utils.py:44-93)
//
// Build: g++ -O3 -march=native -shared -fPIC navgraph.cpp -o libnavgraph.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct StaticGraph {
  int n;
  std::vector<std::vector<std::pair<int, double>>> adj;
  std::vector<double> dist;  // n*n
  std::vector<int> pred;     // n*n predecessor of j on path i->j

  void dijkstra_all() {
    dist.assign((size_t)n * n, kInf);
    pred.assign((size_t)n * n, -1);
    using Item = std::pair<double, int>;
    for (int s = 0; s < n; ++s) {
      double* d = &dist[(size_t)s * n];
      int* p = &pred[(size_t)s * n];
      std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
      d[s] = 0.0;
      pq.push({0.0, s});
      while (!pq.empty()) {
        auto [du, u] = pq.top();
        pq.pop();
        if (du > d[u]) continue;
        for (auto [v, w] : adj[u]) {
          double nd = du + w;
          if (nd < d[v]) {
            d[v] = nd;
            p[v] = u;
            pq.push({nd, v});
          }
        }
      }
    }
  }
};

struct FloydEngine {
  // Dense over a capacity of nodes; nodes are registered incrementally.
  int cap;
  int n = 0;
  std::vector<double> dist;  // cap*cap
  std::vector<int> mid;      // cap*cap, -1 = direct edge / none
  std::vector<uint8_t> visited;

  explicit FloydEngine(int capacity) : cap(capacity) {
    dist.assign((size_t)cap * cap, kInf);
    mid.assign((size_t)cap * cap, -1);
    visited.assign(cap, 0);
    for (int i = 0; i < cap; ++i) dist[(size_t)i * cap + i] = 0.0;
  }

  double& D(int i, int j) { return dist[(size_t)i * cap + j]; }
  int& M(int i, int j) { return mid[(size_t)i * cap + j]; }

  void add_edge(int x, int y, double w) {
    n = std::max(n, std::max(x, y) + 1);
    if (w < D(x, y)) {
      D(x, y) = D(y, x) = w;
      M(x, y) = M(y, x) = -1;
    }
  }

  void update(int k) {
    // relax all known pairs through k (ref FloydGraph.update)
    for (int x = 0; x < n; ++x) {
      double dxk = D(x, k);
      if (dxk == kInf) continue;
      for (int y = 0; y < n; ++y) {
        double through = dxk + D(k, y);
        if (through < D(x, y)) {
          D(x, y) = D(y, x) = through;
          M(x, y) = M(y, x) = k;
        }
      }
    }
    visited[k] = 1;
  }

  int path(int x, int y, int* out, int max_len) const {
    // nodes from x (exclusive) to y (inclusive); returns length or -1
    if (x == y) return 0;
    int k = mid[(size_t)x * cap + y];
    if (k < 0) {
      if (max_len < 1) return -1;
      out[0] = y;
      return 1;
    }
    int a = path(x, k, out, max_len);
    if (a < 0) return -1;
    int b = path(k, y, out + a, max_len - a);
    if (b < 0) return -1;
    return a + b;
  }
};

}  // namespace

extern "C" {

// ----------------------------------------------------------- StaticGraph API
void* sg_create(int n_nodes, const int* edges, const double* weights,
                int n_edges) {
  auto* g = new StaticGraph();
  g->n = n_nodes;
  g->adj.assign(n_nodes, {});
  for (int e = 0; e < n_edges; ++e) {
    int a = edges[2 * e], b = edges[2 * e + 1];
    double w = weights[e];
    g->adj[a].push_back({b, w});
    g->adj[b].push_back({a, w});
  }
  g->dijkstra_all();
  return g;
}

void sg_destroy(void* h) { delete static_cast<StaticGraph*>(h); }

void sg_distances(void* h, double* out) {
  auto* g = static_cast<StaticGraph*>(h);
  std::memcpy(out, g->dist.data(), sizeof(double) * g->n * g->n);
}

double sg_distance(void* h, int i, int j) {
  auto* g = static_cast<StaticGraph*>(h);
  return g->dist[(size_t)i * g->n + j];
}

int sg_path(void* h, int i, int j, int* out, int max_len) {
  auto* g = static_cast<StaticGraph*>(h);
  if (g->dist[(size_t)i * g->n + j] == kInf) return -1;
  // walk predecessors backwards from j
  std::vector<int> rev;
  int cur = j;
  while (cur != i) {
    rev.push_back(cur);
    cur = g->pred[(size_t)i * g->n + cur];
    if (cur < 0) return -1;
  }
  rev.push_back(i);
  int len = (int)rev.size();
  if (len > max_len) return -1;
  for (int k = 0; k < len; ++k) out[k] = rev[len - 1 - k];
  return len;
}

// ----------------------------------------------------------- FloydEngine API
void* fg_create(int capacity) { return new FloydEngine(capacity); }
void fg_destroy(void* h) { delete static_cast<FloydEngine*>(h); }

void fg_add_edge(void* h, int x, int y, double w) {
  static_cast<FloydEngine*>(h)->add_edge(x, y, w);
}

void fg_update(void* h, int k) { static_cast<FloydEngine*>(h)->update(k); }

double fg_distance(void* h, int x, int y) {
  auto* g = static_cast<FloydEngine*>(h);
  return x == y ? 0.0 : g->dist[(size_t)x * g->cap + y];
}

int fg_visited(void* h, int k) {
  return static_cast<FloydEngine*>(h)->visited[k];
}

int fg_path(void* h, int x, int y, int* out, int max_len) {
  return static_cast<FloydEngine*>(h)->path(x, y, out, max_len);
}

// --------------------------------------------------------------- metric DP
// Exact DTW between two (n,3)/(m,3) position sequences under the euclidean
// ground distance. Role of the reference's fastdtw dependency in the CE nDTW
// measure (habitat_extensions/measures.py:266-336) and the trainer-side
// metric assembly (ss_trainer_BEV.py:1184-1209); exact instead of the
// fastdtw radius-1 approximation, and O(m) memory via rolling rows.
double dtw_positions(const double* a, int n, const double* b, int m) {
  const double INF = 1e30;
  std::vector<double> prev((size_t)m + 1, INF), cur((size_t)m + 1, INF);
  prev[0] = 0.0;
  for (int i = 1; i <= n; ++i) {
    cur[0] = INF;
    const double ax = a[(i - 1) * 3], ay = a[(i - 1) * 3 + 1],
                 az = a[(i - 1) * 3 + 2];
    for (int j = 1; j <= m; ++j) {
      const double dx = ax - b[(j - 1) * 3], dy = ay - b[(j - 1) * 3 + 1],
                   dz = az - b[(j - 1) * 3 + 2];
      const double cost = std::sqrt(dx * dx + dy * dy + dz * dz);
      double best = prev[j];                 // insertion
      if (cur[j - 1] < best) best = cur[j - 1];   // deletion
      if (prev[j - 1] < best) best = prev[j - 1]; // match
      cur[j] = cost + best;
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// DTW over a precomputed cost matrix (row-major n x m) — serves the discrete
// eval path where the ground distance is a graph geodesic
// (map_nav_src/r2r/eval_utils.py:6-26 cal_dtw).
double dtw_costmatrix(const double* c, int n, int m) {
  const double INF = 1e30;
  std::vector<double> prev((size_t)m + 1, INF), cur((size_t)m + 1, INF);
  prev[0] = 0.0;
  for (int i = 1; i <= n; ++i) {
    cur[0] = INF;
    const double* row = c + (size_t)(i - 1) * m;
    for (int j = 1; j <= m; ++j) {
      double best = prev[j];
      if (cur[j - 1] < best) best = cur[j - 1];
      if (prev[j - 1] < best) best = prev[j - 1];
      cur[j] = row[j - 1] + best;
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"
