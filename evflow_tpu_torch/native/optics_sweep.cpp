// OPTICS sweep (optics.hpp:525-555), host C++ of evflow_tpu_torch: a seed
// priority queue ordered by (reach_dist, point_index), the reference's
// comparator (optics.hpp:67-69), over a precomputed neighbor table, with a
// lazy-deletion binary heap.
//   nbr_idx:  n*k int32, -1 padded
//   nbr_dist: n*k float64, +inf padded
//   core:     n float64 (+inf when undefined)
// Outputs: order (n int64 visit order), reach (n float64, -1 unreached).
// Built by g++ into a shared library at first use (native/__init__.py).

#include <cstdint>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

namespace {

typedef std::pair<double, int64_t> Seed;
typedef std::priority_queue<Seed, std::vector<Seed>, std::greater<Seed>> SeedQueue;

// relax the unprocessed neighbors of p through p's core distance
void relax(int64_t p, int64_t k, const int32_t* nbr_idx, const double* nbr_dist,
           const double* core, const std::vector<uint8_t>& processed, double* reach,
           SeedQueue& seeds) {
  const int32_t* ni = nbr_idx + p * k;
  const double* nd = nbr_dist + p * k;
  double cd = core[p];
  for (int64_t j = 0; j < k; j++) {
    int32_t o = ni[j];
    if (o < 0 || !(nd[j] < 1e300)) continue;  // a pad, wherever it sits
    if (processed[o]) continue;
    double r = cd > nd[j] ? cd : nd[j];
    if (reach[o] < 0.0 || r < reach[o]) {
      reach[o] = r;
      seeds.push({r, o});
    }
  }
}

}  // namespace

extern "C" {

void optics_sweep(int64_t n, int64_t k, const int32_t* nbr_idx,
                  const double* nbr_dist, const double* core, int64_t* order,
                  double* reach) {
  std::vector<uint8_t> processed(n, 0);
  for (int64_t i = 0; i < n; i++) reach[i] = -1.0;
  int64_t out = 0;
  SeedQueue seeds;

  for (int64_t start = 0; start < n; start++) {
    if (processed[start]) continue;
    processed[start] = 1;
    order[out++] = start;
    if (!(core[start] < 1e300)) continue;
    relax(start, k, nbr_idx, nbr_dist, core, processed, reach, seeds);
    while (!seeds.empty()) {
      Seed s = seeds.top();
      seeds.pop();
      int64_t idx = s.second;
      if (processed[idx] || s.first != reach[idx]) continue;  // stale
      processed[idx] = 1;
      order[out++] = idx;
      if (!(core[idx] < 1e300)) continue;
      relax(idx, k, nbr_idx, nbr_dist, core, processed, reach, seeds);
    }
  }
}

}  // extern "C"
