// DBSCAN's eps-neighbourhood tests of D-dimensional rows against points,
// D = 2 (event pixels) or 3 (point clouds).
//
// Replaces no TPU kernel: the JAX package's DBSCAN
// (evflow_tpu/models/dbscan.py) is plain XLA. Its dense fallback, the path
// every busy event slice takes, rebuilt eight (2048, N) float32 panels per
// pass (both squared norms, the cross term, the sum, the compare, the
// select and the reduction, each a launch over the panel): ~8 ms of device
// time per pass at N = 16384, 7-8 passes a slice. This kernel tests every
// (row, point) pair on the fly, writes no distance, and reduces per row to
// one int32:
//   count mode (plabel null): the number of points j within eps of the row
//     with pflag[j], or 0 for a row whose rflag is 0;
//   min-label mode: the lowest plabel[j] over points j within eps with
//     pflag[j] (core points), or 2^31 - 1 where there is none; with rlabel,
//     the propagation round's epilogue: rflag[i] ? min(rlabel[i], that)
//     : rlabel[i].
//
// Bit-equality with ops/distance.py:pairwise_sqdist. Per pair the test is
// that function's matmul-free form, in its order, term by term from the
// first coordinate:
//   a2 = (ax*ax + ay*ay) + az*az, b2 likewise, cross = (ax*bx + ay*by) + az*bz,
//   d = (a2 + b2) - 2*cross, and the test d <= eps2,
// each rounding spelled out with __fmul_rn/__fadd_rn/__fsub_rn: nvcc's
// default -fmad=true would contract them into FMAs and change bits on
// non-integer points. The panels clamp d at 0 with torch.maximum, which keeps
// NaN; the clamp changes no test while eps2 >= 0, so it is left out. It must
// not become fmaxf: fmaxf(NaN, 0) is 0, and a NaN is what two invalid lanes
// parked at 1e30 give (inf - inf), so fmaxf would make them neighbours.
// Integer minima and counts are exact in any order, so the result is the
// same bits as the panels' on any float32 input.
//
// What bounds it: every pair is tested, 2D + 3 fp32 operations each (D
// muls and D - 1 adds for the cross term, the squared norms' add, the x2,
// the sub, the compare): 7 at D = 2, 1.88 GFLOP at N = 16384, 28 us at the
// card's 67 TFLOP/s. The bytes (4 (D + 1) per row and per point) are
// nothing beside that. Without FMAs each operation is one instruction, and
// with the count or the minimum a pair issues 2D + 4, so the issue rate,
// not the FLOP peak, is the ceiling.
//
// Tiling: a CTA of 8 warps owns 64 rows, 8 per warp, whose coordinates and
// a2 stay in registers: 8 independent tests per point loaded, for ILP.
// The points stream through shared memory in chunks of 512, computed once
// per CTA: at D = 2 one float4 (x, y, b2, the flag or core label as int
// bits), at D = 3 a float4 (x, y, z, b2) and an int32 beside it. The next
// chunk's loads are issued before the current chunk's tests, and a double
// buffer needs one barrier per chunk. Lanes stride the chunk's points
// (conflict-free reads), and a warp's lanes reduce their partial counts or
// minima by shuffles at the end: one launch, no atomics, no output to
// initialise. At M = 16384 that is 256 CTAs, about two per SM. Padding
// points are NaN and padding rows are never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                        // rows per warp
constexpr int kRowsPerCta = kWarps * kRows;
constexpr int kChunk = 512;                     // points per shared-memory chunk
constexpr int kStage = kChunk / kThreads;       // points each thread stages
constexpr int32_t kNone = 0x7fffffff;           // no core neighbour
static_assert(kChunk % kThreads == 0 && kChunk % 32 == 0, "a chunk is whole stages");
constexpr unsigned kFull = 0xffffffffu;

// the squared norm of a point, term by term from its first coordinate
template <int D>
__device__ __forceinline__ float sq_norm(const float (&p)[D]) {
  float s = __fmul_rn(p[0], p[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(p[d], p[d]));
  return s;
}

// a chunk of staged points in shared memory: D = 2 packs the value into the
// float4's w, D = 3 keeps it in an int32 array beside (x, y, z, b2)
template <int D> struct Tile;
template <> struct Tile<2> {
  float4 p[2][kChunk];
  __device__ __forceinline__ void put(int buf, int k, const float (&c)[2], float b2, int32_t v) {
    p[buf][k] = make_float4(c[0], c[1], b2, __int_as_float(v));
  }
  __device__ __forceinline__ void get(int buf, int k, float (&c)[2], float& b2,
                                      int32_t& v) const {
    const float4 q = p[buf][k];
    c[0] = q.x;
    c[1] = q.y;
    b2 = q.z;
    v = __float_as_int(q.w);
  }
};
template <> struct Tile<3> {
  float4 p[2][kChunk];
  int32_t val[2][kChunk];
  __device__ __forceinline__ void put(int buf, int k, const float (&c)[3], float b2, int32_t v) {
    p[buf][k] = make_float4(c[0], c[1], c[2], b2);
    val[buf][k] = v;
  }
  __device__ __forceinline__ void get(int buf, int k, float (&c)[3], float& b2,
                                      int32_t& v) const {
    const float4 q = p[buf][k];
    c[0] = q.x;
    c[1] = q.y;
    c[2] = q.z;
    b2 = q.w;
    v = val[buf][k];
  }
};

template <int D, bool kMin>
__global__ void __launch_bounds__(kThreads)
dbscan_eps_kernel(const float* __restrict__ rows, int m,
                  const float* __restrict__ pts, int n, float eps2,
                  const uint8_t* __restrict__ pflag,
                  const int32_t* __restrict__ plabel,
                  const uint8_t* __restrict__ rflag,
                  const int32_t* __restrict__ rlabel, int32_t* __restrict__ out) {
  __shared__ Tile<D> tile;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5) * kRows;
  const float nan = __int_as_float(0x7fc00000);
  const int32_t identity = kMin ? kNone : 0;

  float a[kRows][D], a2[kRows];
  int32_t acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int d = 0; d < D; ++d) a[r][d] = i < m ? __ldg(rows + (size_t)i * D + d) : nan;
    a2[r] = sq_norm<D>(a[r]);
    acc[r] = identity;
  }

  // each thread stages kStage points of a chunk: loaded into registers,
  // then written to shared memory with their squared norms
  float sp[kStage][D];
  int32_t sv[kStage];
  auto fetch = [&](int base) {
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int j = base + q * kThreads + threadIdx.x;
#pragma unroll
      for (int d = 0; d < D; ++d) sp[q][d] = j < n ? __ldg(pts + (size_t)j * D + d) : nan;
      sv[q] = identity;
      if (j < n) {
        const bool f = __ldg(pflag + j) != 0;
        sv[q] = kMin ? (f ? __ldg(plabel + j) : kNone) : (f ? 1 : 0);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      tile.put(buf, q * kThreads + threadIdx.x, sp[q], sq_norm<D>(sp[q]), sv[q]);
  };

  const int chunks = (n + kChunk - 1) / kChunk;
  if (chunks > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch((c + 1) * kChunk);
#pragma unroll 4
    for (int k = lane; k < kChunk; k += 32) {
      float b[D], b2;
      int32_t v;
      tile.get(c & 1, k, b, b2, v);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float cross = __fmul_rn(a[r][0], b[0]);
#pragma unroll
        for (int d = 1; d < D; ++d) cross = __fadd_rn(cross, __fmul_rn(a[r][d], b[d]));
        const float dist = __fsub_rn(__fadd_rn(a2[r], b2), __fmul_rn(2.0f, cross));
        if (dist <= eps2) acc[r] = kMin ? min(acc[r], v) : acc[r] + v;
      }
    }
    if (c + 1 < chunks) stash((c + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t o = __shfl_xor_sync(kFull, acc[r], off);
      acc[r] = kMin ? min(acc[r], o) : acc[r] + o;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
    if (lane != r || i >= m) continue;
    int32_t v = acc[r];
    if (!kMin)
      v = rflag[i] ? v : 0;
    else if (rlabel != nullptr)
      v = rflag[i] ? min(rlabel[i], v) : rlabel[i];
    out[i] = v;
  }
}

template <int D>
void launch(int blocks, cudaStream_t s, const float* r, int m, const float* p, int n,
            float eps2, const uint8_t* pf, const int32_t* pl, const uint8_t* rf,
            const int32_t* rl, int32_t* o) {
  if (pl != nullptr)
    dbscan_eps_kernel<D, true><<<blocks, kThreads, 0, s>>>(r, m, p, n, eps2, pf, pl, rf, rl, o);
  else
    dbscan_eps_kernel<D, false><<<blocks, kThreads, 0, s>>>(r, m, p, n, eps2, pf, nullptr, rf,
                                                             nullptr, o);
}

}  // namespace

extern "C" int dbscan_eps(const void* rows, int m, const void* points, int n, int d, float eps2,
                          const void* pflag, const void* plabel, const void* rflag,
                          const void* rlabel, void* out, void* stream) {
  const bool count = plabel == nullptr;
  if (m < 1 || n < 0 || (d != 2 && d != 3) ||
      (count && (rflag == nullptr || rlabel != nullptr)) ||
      (rlabel != nullptr && rflag == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (m + kRowsPerCta - 1) / kRowsPerCta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rows);
  const auto* p = static_cast<const float*>(points);
  const auto* pf = static_cast<const uint8_t*>(pflag);
  const auto* pl = static_cast<const int32_t*>(plabel);
  const auto* rf = static_cast<const uint8_t*>(rflag);
  const auto* rl = static_cast<const int32_t*>(rlabel);
  auto* o = static_cast<int32_t*>(out);
  if (d == 2)
    launch<2>(blocks, s, r, m, p, n, eps2, pf, pl, rf, rl, o);
  else
    launch<3>(blocks, s, r, m, p, n, eps2, pf, pl, rf, rl, o);
  return (int)cudaGetLastError();
}
