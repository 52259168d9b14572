// Per-slice cluster statistics with stream-order EWMA weights.
//
// Replaces evflow_tpu/ops/pallas_kernels.py:cluster_stats (the Pallas kernel
// _cluster_stats_kernel), i.e. fastcluster steps 3-4 (fastcluster.py:
// 361-369): for labels (N,) int32 (-1 = none) and x, y (N,) f32, the (C, 5)
// f32 rows [k, sum x, sum y, sum w x, sum w y], where k is the cluster's
// member count, rank the member's stream-order position within its cluster
// and w = alpha * (1 - alpha)^clip(k - 1 - rank, 0, 80).
//
// One CTA per cluster scans the N labels in order, twice: once to count k,
// once to rank. Within a 256-label chunk a warp ballot and popcount give each
// member its rank among the chunk's earlier lanes, and the per-warp counts
// (double-buffered in shared memory, one barrier per chunk) give the chunk
// offsets. Every thread keeps partial sums; a fixed shuffle-then-shared tree
// combines them. No atomics, so the result is deterministic. Counts and
// ranks are exact integers; sum x and sum y add integer-valued f32, exact in
// any order below 2^24; only the weighted sums depend on the f32 order.
// expf/log1pf in f32, no fast-math.
//
// What bounds it: each CTA reads the 64 KB label array twice from L2 (128
// CTAs: ~16 MB of L2 traffic per slice) with one barrier per chunk; the
// arithmetic is negligible.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
cluster_stats_kernel(const int32_t* __restrict__ labels,
                     const float* __restrict__ x, const float* __restrict__ y,
                     int n, float alpha, float* __restrict__ out) {
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int warp_cnt[2][kWarps];
  __shared__ float part[4][kWarps];
  __shared__ int total;

  // pass 1: member count k
  int cnt = 0;
  for (int i = tid; i < n; i += kThreads) cnt += labels[i] == c;
  cnt = warp_sum_int(cnt);
  if (lane == 0) warp_cnt[0][warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int k = 0;
    for (int w = 0; w < kWarps; ++w) k += warp_cnt[0][w];
    total = k;
  }
  __syncthreads();
  const int k = total;

  // pass 2: stream-order ranks, weights and sums
  const float la = log1pf(-alpha);
  float sx = 0.f, sy = 0.f, swx = 0.f, swy = 0.f;
  int running = 0;
  int buf = 1;  // warp_cnt[0] was last read before the barrier above
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool member = i < n && labels[i] == c;
    const unsigned ballot = __ballot_sync(0xffffffffu, member);
    if (lane == 0) warp_cnt[buf][warp] = __popc(ballot);
    __syncthreads();
    int before = running, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_cnt[buf][w];
      before += w < warp ? v : 0;
      chunk += v;
    }
    if (member) {
      const int rank = before + __popc(ballot & ((1u << lane) - 1u));
      const float expo = fminf(fmaxf(static_cast<float>(k - 1 - rank), 0.f), 80.f);
      const float wgt = alpha * expf(expo * la);
      const float xi = x[i], yi = y[i];
      sx += xi;
      sy += yi;
      swx += wgt * xi;
      swy += wgt * yi;
    }
    running += chunk;
    buf ^= 1;
  }

  sx = warp_sum(sx);
  sy = warp_sum(sy);
  swx = warp_sum(swx);
  swy = warp_sum(swy);
  if (lane == 0) {
    part[0][warp] = sx;
    part[1][warp] = sy;
    part[2][warp] = swx;
    part[3][warp] = swy;
  }
  __syncthreads();
  if (tid < 4) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[tid][w];
    out[c * 5 + 1 + tid] = s;
  }
  if (tid == 0) out[c * 5] = static_cast<float>(k);
}

}  // namespace

extern "C" int cluster_stats(const void* labels, const void* x, const void* y,
                             int n, int c, float alpha, void* out,
                             void* stream) {
  cluster_stats_kernel<<<c, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(labels), static_cast<const float*>(x),
      static_cast<const float*>(y), n, alpha, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
