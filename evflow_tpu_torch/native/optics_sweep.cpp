// OPTICS sweep (optics.hpp:525-555), host C++ of evflow_tpu_torch: a seed
// priority queue ordered by (reach_dist, point_index), the reference's
// comparator (optics.hpp:67-69), over a precomputed neighbor table, with a
// lazy-deletion binary heap.
//   nbr_idx:  n*k int32, -1 padded
//   nbr_dist: n*k float64 (optics_sweep) or float32 (optics_sweep_f32),
//             +inf padded
//   core:     n, the distances' type (+inf when undefined)
// Outputs: order (n int64 visit order), reach (n, the distances' type, -1
// unreached). Every reach is one of the table's distances, so the float32
// entry gives the float64 entry's order and values on a float32 table.
// Built by g++ into a shared library at first use (native/__init__.py).

#include <cstdint>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

namespace {

template <typename T>
using SeedQueue = std::priority_queue<std::pair<T, int64_t>,
                                      std::vector<std::pair<T, int64_t>>,
                                      std::greater<std::pair<T, int64_t>>>;

// relax the unprocessed neighbors of p through p's core distance
template <typename T>
void relax(int64_t p, int64_t k, const int32_t* nbr_idx, const T* nbr_dist, const T* core,
           const std::vector<uint8_t>& processed, T* reach, SeedQueue<T>& seeds) {
  const int32_t* ni = nbr_idx + p * k;
  const T* nd = nbr_dist + p * k;
  T cd = core[p];
  for (int64_t j = 0; j < k; j++) {
    int32_t o = ni[j];
    if (o < 0 || !(nd[j] < 1e300)) continue;  // a pad, wherever it sits
    if (processed[o]) continue;
    T r = cd > nd[j] ? cd : nd[j];
    if (reach[o] < 0 || r < reach[o]) {
      reach[o] = r;
      seeds.push({r, o});
    }
  }
}

template <typename T>
void sweep(int64_t n, int64_t k, const int32_t* nbr_idx, const T* nbr_dist, const T* core,
           int64_t* order, T* reach) {
  std::vector<uint8_t> processed(n, 0);
  for (int64_t i = 0; i < n; i++) reach[i] = -1;
  int64_t out = 0;
  SeedQueue<T> seeds;

  for (int64_t start = 0; start < n; start++) {
    if (processed[start]) continue;
    processed[start] = 1;
    order[out++] = start;
    if (!(core[start] < 1e300)) continue;
    relax(start, k, nbr_idx, nbr_dist, core, processed, reach, seeds);
    while (!seeds.empty()) {
      std::pair<T, int64_t> s = seeds.top();
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

}  // namespace

extern "C" {

void optics_sweep(int64_t n, int64_t k, const int32_t* nbr_idx, const double* nbr_dist,
                  const double* core, int64_t* order, double* reach) {
  sweep<double>(n, k, nbr_idx, nbr_dist, core, order, reach);
}

void optics_sweep_f32(int64_t n, int64_t k, const int32_t* nbr_idx, const float* nbr_dist,
                      const float* core, int64_t* order, float* reach) {
  sweep<float>(n, k, nbr_idx, nbr_dist, core, order, reach);
}

}  // extern "C"
