// Gated Manhattan assignment of events to cluster means.
//
// Replaces evflow_tpu/ops/pallas_kernels.py:assign_manhattan (the Pallas
// kernel _assign_kernel), i.e. fastcluster step 1 (fastcluster.py:270-276):
// for each event the L1 distance to each of the C means, +inf for dead
// clusters, the argmin with the LOWEST index winning ties, the minimum
// distance, and label -1 where that distance exceeds the radius. The
// distance is |x - mx| + |y - my| in f32 exactly as the plain version
// computes it (no multiply, so no FMA contraction), so labels and distances
// are bit-equal to it.
//
// What bounds it on an H100: at the main path's size (N = 16384, C = 128,
// 34 clusters alive on chip_smoke's phase-2 input) the work is N x n_alive
// distances of ~6 fp32 ops and 16 bytes per event in and out: under 0.1 us
// at the card's peaks, far below one launch. So the kernel is bound by its
// latency chain: the loads, the compaction of the means, and the loop over
// the means per event. (The previous design looped every event over all C
// slots with a branch per dead one, in 64 CTAs of 256 threads.)
//
// Design: one warp per CTA, two events per thread with 8-byte loads and
// stores: 256 CTAs at N = 16384, so every one of the 132 SMs has work. Each
// CTA issues its event loads, then compacts the ALIVE means into shared
// memory in index order (a warp ballot and a popcount prefix per 32 flags),
// padded to an even count with a mean at +inf, and each thread loops over
// n_alive means only, two at a time as one float4. Each event keeps two
// partial minima, over the even and the odd compacted positions; each
// replaces its best only on a strict `<`, so it holds the first position of
// its minimum, and the two merge lexicographically on (distance, position).
// Compaction keeps index order, so the first position is the lowest index:
// the first-index rule survives the unroll. With no alive cluster the
// result is dist = +inf, label -1 (index 0 if the radius is +inf), as in
// the plain version.
//
// Shared memory: 8 bytes per mean (rounded up to an even count) and 4 per
// index, 49,152 bytes at C = 4096 (cluster_kernels.MAX_CLUSTERS).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // one warp per CTA
constexpr int kEvents = 2;     // events per thread
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
assign_manhattan_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ y, int n,
                        const float* __restrict__ mu,
                        const uint8_t* __restrict__ alive, int c, float radius,
                        int32_t* __restrict__ labels,
                        float* __restrict__ dist) {
  extern __shared__ __align__(16) float smem[];
  const int ce = (c + 1) & ~1;
  float2* means = reinterpret_cast<float2*>(smem);     // [ce] alive, in order
  int* index = reinterpret_cast<int*>(means + ce);     // [c] their slots
  const int lane = threadIdx.x;
  const int i0 = (blockIdx.x * kThreads + lane) * kEvents;

  // the events first, so their loads overlap the compaction
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(labels) |
                     reinterpret_cast<uintptr_t>(dist)) & 7) == 0;
  const bool pair = vec && i0 + 1 < n;
  float px[kEvents], py[kEvents];
  if (pair) {
    const int2 a = *reinterpret_cast<const int2*>(x + i0);
    const int2 b = *reinterpret_cast<const int2*>(y + i0);
    px[0] = static_cast<float>(a.x);
    px[1] = static_cast<float>(a.y);
    py[0] = static_cast<float>(b.x);
    py[1] = static_cast<float>(b.y);
  } else {
#pragma unroll
    for (int e = 0; e < kEvents; ++e) {
      const int i = i0 + e;
      px[e] = i < n ? static_cast<float>(x[i]) : 0.f;
      py[e] = i < n ? static_cast<float>(y[i]) : 0.f;
    }
  }

  // compact the alive means in index order
  const unsigned lower = (1u << lane) - 1u;
  int n_alive = 0;
#pragma unroll 4
  for (int b = 0; b < c; b += 32) {
    const int j = b + lane;
    const bool a = j < c && alive[j];
    const unsigned ballot = __ballot_sync(kFull, a);
    if (a) {
      const int p = n_alive + __popc(ballot & lower);
      means[p] = make_float2(mu[2 * j], mu[2 * j + 1]);
      index[p] = j;
    }
    n_alive += __popc(ballot);
  }
  if (lane == 0 && (n_alive & 1)) means[n_alive] = make_float2(INFINITY, INFINITY);
  __syncwarp();

  // two partial minima per event: even and odd compacted positions
  float best_e[kEvents], best_o[kEvents];
  int at_e[kEvents], at_o[kEvents];
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    best_e[e] = best_o[e] = INFINITY;
    at_e[e] = at_o[e] = -1;
  }
  const float4* pairs = reinterpret_cast<const float4*>(means);
  const int n_pairs = (n_alive + 1) >> 1;
#pragma unroll 4
  for (int p = 0; p < n_pairs; ++p) {
    const float4 m = pairs[p];
#pragma unroll
    for (int e = 0; e < kEvents; ++e) {
      const float d0 = fabsf(px[e] - m.x) + fabsf(py[e] - m.y);
      const float d1 = fabsf(px[e] - m.z) + fabsf(py[e] - m.w);
      if (d0 < best_e[e]) {
        best_e[e] = d0;
        at_e[e] = 2 * p;
      }
      if (d1 < best_o[e]) {
        best_o[e] = d1;
        at_o[e] = 2 * p + 1;
      }
    }
  }

  int lab[kEvents];
  float bd[kEvents];
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    const bool odd = best_o[e] < best_e[e] ||
                     (best_o[e] == best_e[e] && at_o[e] >= 0 && at_o[e] < at_e[e]);
    const int at = odd ? at_o[e] : at_e[e];
    bd[e] = odd ? best_o[e] : best_e[e];
    const int slot = at >= 0 ? index[at] : 0;
    lab[e] = bd[e] <= radius ? slot : -1;
  }
  if (pair) {
    *reinterpret_cast<int2*>(labels + i0) = make_int2(lab[0], lab[1]);
    *reinterpret_cast<float2*>(dist + i0) = make_float2(bd[0], bd[1]);
  } else {
#pragma unroll
    for (int e = 0; e < kEvents; ++e) {
      if (i0 + e < n) {
        labels[i0 + e] = lab[e];
        dist[i0 + e] = bd[e];
      }
    }
  }
}

}  // namespace

extern "C" int assign_manhattan(const void* x, const void* y, int n,
                                const void* mu, const void* alive, int c,
                                float radius, void* labels, void* dist,
                                void* stream) {
  const size_t smem = (size_t)((c + 1) & ~1) * sizeof(float2) + (size_t)c * sizeof(int);
  static size_t granted = 48 * 1024;   // above it only by opting in
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        assign_manhattan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const int per_cta = kThreads * kEvents;
  const int blocks = (n + per_cta - 1) / per_cta;
  assign_manhattan_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y), n,
      static_cast<const float*>(mu), static_cast<const uint8_t*>(alive), c,
      radius, static_cast<int32_t*>(labels), static_cast<float*>(dist));
  return (int)cudaGetLastError();
}
