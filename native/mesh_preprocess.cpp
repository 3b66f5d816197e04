// Native mesh-preprocessing kernels for mpas_ocean.
//
// Host-side setup paths that are latency-sensitive at production mesh
// scales (millions of cells): breadth-first graph partitioning and reverse
// Cuthill-McKee reordering over the cell adjacency graph (CSR form).
// Exposed as a plain C ABI consumed via ctypes (native/__init__.py); a
// NumPy fallback with identical semantics lives in
// mpas_ocean/parallel/graph.py.
//
// Build: g++ -O3 -shared -fPIC -o libmeshpre.so mesh_preprocess.cpp

#include <cstdint>
#include <queue>
#include <vector>
#include <algorithm>
#include <numeric>

extern "C" {

// Reverse Cuthill-McKee ordering of an undirected graph in CSR form.
// Writes a permutation `order` such that order[i] = old index of the node
// placed at new position i. Returns 0 on success.
int rcm_order(int64_t n, const int64_t* xadj, const int64_t* adjncy,
              int64_t* order) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = xadj[i + 1] - xadj[i];
  std::vector<char> visited(n, 0);
  std::vector<int64_t> result;
  result.reserve(n);
  std::vector<int64_t> nbrs;

  // process every connected component, seeding from min-degree nodes
  std::vector<int64_t> by_degree(n);
  std::iota(by_degree.begin(), by_degree.end(), 0);
  std::stable_sort(by_degree.begin(), by_degree.end(),
            [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });

  for (int64_t seed_i = 0; seed_i < n; ++seed_i) {
    int64_t seed = by_degree[seed_i];
    if (visited[seed]) continue;
    std::queue<int64_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      result.push_back(u);
      nbrs.clear();
      for (int64_t k = xadj[u]; k < xadj[u + 1]; ++k) {
        int64_t v = adjncy[k];
        if (v >= 0 && v < n && !visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (int64_t v : nbrs) q.push(v);
    }
  }
  if ((int64_t)result.size() != n) return 1;
  // reverse for RCM
  for (int64_t i = 0; i < n; ++i) order[i] = result[n - 1 - i];
  return 0;
}

// Balanced BFS graph-growing partition: grows `nparts` contiguous regions
// of (nearly) equal size from spread-out seeds. part[i] in [0, nparts).
int greedy_partition(int64_t n, const int64_t* xadj, const int64_t* adjncy,
                     int64_t nparts, int64_t* part) {
  if (nparts <= 0) return 1;
  std::vector<int64_t> order(n);
  if (rcm_order(n, xadj, adjncy, order.data()) != 0) return 1;

  std::fill(part, part + n, int64_t(-1));
  int64_t assigned = 0;
  // walk the RCM order; grow each part by BFS until its quota is met
  int64_t cursor = 0;
  for (int64_t p = 0; p < nparts; ++p) {
    int64_t quota = (n * (p + 1)) / nparts - (n * p) / nparts;
    std::queue<int64_t> q;
    while (quota > 0) {
      if (q.empty()) {
        while (cursor < n && part[order[cursor]] != -1) ++cursor;
        if (cursor >= n) break;
        q.push(order[cursor]);
        part[order[cursor]] = p;
        --quota;
        ++assigned;
      }
      int64_t u = q.front();
      q.pop();
      for (int64_t k = xadj[u]; k < xadj[u + 1] && quota > 0; ++k) {
        int64_t v = adjncy[k];
        if (v >= 0 && v < n && part[v] == -1) {
          part[v] = p;
          --quota;
          ++assigned;
          q.push(v);
        }
      }
    }
  }
  // sweep up any stragglers (disconnected leftovers)
  for (int64_t i = 0; i < n; ++i)
    if (part[i] == -1) {
      part[i] = nparts - 1;
      ++assigned;
    }
  return assigned == n ? 0 : 1;
}

}  // extern "C"
