// Gated Manhattan assignment of events to cluster means.
//
// Replaces evflow_tpu/ops/pallas_kernels.py:assign_manhattan (the Pallas
// kernel _assign_kernel), i.e. fastcluster step 1 (fastcluster.py:270-276):
// for each event the L1 distance to each of the C means, +inf for dead
// clusters, the argmin with the LOWEST index winning ties, the minimum
// distance, and label -1 where that distance exceeds the radius.
//
// One thread per event; the C means and alive flags sit in shared memory and
// every thread of a warp reads the same entry (a broadcast). The tie rule is
// written out: a later cluster replaces the best only on a strict `<`.
// The distance is |x - mx| + |y - my| in f32 exactly as the plain version
// computes it (no multiply, so no FMA contraction), so labels and distances
// are bit-equal to it.
//
// What bounds it: N*C (2M at 16384 x 128) distance evaluations, ~5 ops each,
// plus 8 bytes read and 8 written per event: a few microseconds of work, so
// at this size the launch itself dominates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
assign_manhattan_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ y, int n,
                        const float* __restrict__ mu,
                        const uint8_t* __restrict__ alive, int c, float radius,
                        int32_t* __restrict__ labels,
                        float* __restrict__ dist) {
  extern __shared__ float smem[];
  float* mux = smem;
  float* muy = smem + c;
  int* live = reinterpret_cast<int*>(smem + 2 * c);
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    mux[j] = mu[2 * j];
    muy[j] = mu[2 * j + 1];
    live[j] = alive[j];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = static_cast<float>(x[i]);
  const float py = static_cast<float>(y[i]);
  float best_d = INFINITY;
  int best = 0;
  for (int j = 0; j < c; ++j) {
    const float d = live[j] ? fabsf(px - mux[j]) + fabsf(py - muy[j]) : INFINITY;
    if (d < best_d) {
      best_d = d;
      best = j;
    }
  }
  labels[i] = best_d <= radius ? best : -1;
  dist[i] = best_d;
}

}  // namespace

extern "C" int assign_manhattan(const void* x, const void* y, int n,
                                const void* mu, const void* alive, int c,
                                float radius, void* labels, void* dist,
                                void* stream) {
  const size_t smem = (size_t)c * (2 * sizeof(float) + sizeof(int));
  const int blocks = (n + kThreads - 1) / kThreads;
  assign_manhattan_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y), n,
      static_cast<const float*>(mu), static_cast<const uint8_t*>(alive), c,
      radius, static_cast<int32_t*>(labels), static_cast<float*>(dist));
  return (int)cudaGetLastError();
}
