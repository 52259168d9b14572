// The corner path's representative candidates: for each of R rows of n
// events, one lane per touched pixel, the pixel's last lane in stream order,
// compacted in lane order to m slots.
//
// Replaces no TPU kernel: the JAX package picks them with two sorts in
// plain XLA (evflow_tpu/models/pipeline.py:_representative_candidates). Its
// plain PyTorch form (models/pipeline.py:_representative_candidates) is an
// int64 sort of (pixel, reversed lane) keys, a boundary mask, a scatter and
// a stable-sort compaction: about 39 launches per row, and the q = 8 path
// ran it once per sub-slice, 8 times a slice.
//
// Row r's outputs equal the plain form's on that row, bit for bit, for any
// int32 x and y:
//   key(i) = valid[i] ? y[i] * (W + 1) + x[i] : off,  off = (W + 1) * (H + 1),
//     in int32, wrapping as PyTorch's int32 arithmetic does;
//   lane i is a representative iff key(i) < off (signed: negative keys are
//     candidates) and no later lane of the row has the same key;
//   cx, cy, cvalid: the first m representatives' x, y and true, in lane
//     order, then zeros and false up to m (also where m > n);
//   n_dropped[r] = max(representatives - m, 0).
//
// What bounds it: at the q = 8 path's size, 8 rows of 2,048 lanes into 1,024
// slots, the bytes are 9 per lane in and 9 per slot out, 221 KB a slice,
// 0.07 us at the card's bandwidth: far below one launch. The design keeps it
// to one launch and one pass over shared memory:
// - one CTA of 512 threads per row (8 CTAs at q = 8);
// - an open-addressing table of S = 2^k >= 2n slots and the row's n keys,
//   in dynamic shared memory ((S + n) * 4 bytes: 24 KB at n = 2,048, 192 KB
//   at the q = 1 path's single row of 16,384); a row too large for shared
//   memory takes the same table in a global workspace the caller passes;
// - a slot holds a lane. A candidate probes linearly from its key's
//   multiplicative hash: it claims an empty slot with atomicCAS, or, where
//   the occupant's key is its own, raises the slot to its lane with
//   atomicMax. The slot of a key ends up holding the key's last lane
//   whatever the order of the atomics, and a slot never changes key;
// - after one barrier, lane i is a representative iff its key's slot holds
//   i. Each warp owns a contiguous run of 32 * run lanes of a tile, its
//   lanes stride the run (conflict-free key reads, coalesced x and y), and a
//   lane keeps its flags as bits. The warps' counts are scanned in shared
//   memory; a flag's slot is its warp's base plus the ballots' population
//   counts before it. Tiles of 512 * 32 lanes follow each other in order;
// - no host work: every output element is written, nothing is zeroed or
//   uploaded beforehand, and nothing syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRun = 32;              // lanes per thread in a tile: one bit each
constexpr int32_t kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kHashMul = 0x9E3779B1u;
static_assert(kWarps <= 32, "one warp scans the warps' counts");

__device__ __forceinline__ unsigned home_slot(int32_t key, int shift) {
  return ((unsigned)key * kHashMul) >> shift;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// kGlobal: the table and keys in the workspace (rows too large for shared
// memory), else in dynamic shared memory
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
rep_candidates_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const uint8_t* __restrict__ valid, int n, int m, int w1, int off,
                      int log2s, int32_t* workspace, int32_t* __restrict__ cx,
                      int32_t* __restrict__ cy, uint8_t* __restrict__ cvalid,
                      int32_t* __restrict__ n_dropped) {
  extern __shared__ int32_t smem[];
  __shared__ int warp_count[kWarps], warp_off[kWarps], tile_count;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = 1 << log2s, shift = 32 - log2s;
  const unsigned mask = (unsigned)slots - 1u;
  int32_t* table = kGlobal ? workspace + (size_t)row * (slots + n) : smem;
  int32_t* keys = table + slots;
  // a slot's occupant may change under other threads' atomics: read it fresh
  volatile int32_t* vtable = table;
  x += (size_t)row * n;
  y += (size_t)row * n;
  valid += (size_t)row * n;
  cx += (size_t)row * m;
  cy += (size_t)row * m;
  cvalid += (size_t)row * m;

  // 1. an empty table; each lane's key
  for (int s = tid; s < slots; s += kThreads) table[s] = kEmpty;
  for (int i = tid; i < n; i += kThreads)
    keys[i] = __ldg(valid + i)
                  ? (int32_t)((uint32_t)__ldg(y + i) * (uint32_t)w1 + (uint32_t)__ldg(x + i))
                  : off;
  __syncthreads();

  // 2. each candidate key's slot ends up holding its last lane
  for (int i = tid; i < n; i += kThreads) {
    const int32_t key = keys[i];
    if (key >= off) continue;
    unsigned s = home_slot(key, shift);
    while (true) {
      int32_t cur = vtable[s];
      if (cur == kEmpty) {
        cur = atomicCAS(table + s, kEmpty, i);
        if (cur == kEmpty) break;
      }
      if (keys[cur] == key) {
        atomicMax(table + s, i);
        break;
      }
      s = (s + 1u) & mask;
    }
  }
  __syncthreads();

  // 3. representatives in lane order, tile by tile
  const int run = min(kMaxRun, max(1, (n + kThreads - 1) / kThreads));
  const int tile = run * kThreads;
  const unsigned before_me = (1u << lane) - 1u;
  int base = 0;   // representatives in earlier tiles
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int first = t0 + warp * 32 * run + lane;
    unsigned bits = 0;
    for (int j = 0; j < run; ++j) {
      const int i = first + 32 * j;
      if (i >= n) break;
      const int32_t key = keys[i];
      if (key >= off) continue;
      unsigned s = home_slot(key, shift);
      int32_t cur;
      while (keys[cur = vtable[s]] != key) s = (s + 1u) & mask;
      if (cur == i) bits |= 1u << j;
    }
    const int count = warp_inclusive_sum(__popc(bits));   // lane 31: the warp's count
    if (lane == 31) warp_count[warp] = count;
    __syncthreads();
    if (warp == 0) {
      const int c = lane < kWarps ? warp_count[lane] : 0;
      const int inc = warp_inclusive_sum(c);
      if (lane < kWarps) warp_off[lane] = inc - c;
      if (lane == kWarps - 1) tile_count = inc;
    }
    __syncthreads();
    // the next tile writes warp_count first, then these after a barrier
    int pos = base + warp_off[warp];
    for (int j = 0; j < run; ++j) {
      const unsigned b = __ballot_sync(kFull, (bits >> j) & 1u);
      if ((bits >> j) & 1u) {
        const int p = pos + __popc(b & before_me);
        if (p < m) {
          const int i = first + 32 * j;
          cx[p] = __ldg(x + i);
          cy[p] = __ldg(y + i);
          cvalid[p] = 1;
        }
      }
      pos += __popc(b);
    }
    base += tile_count;
  }

  // 4. the tail, and the count beyond the cap
  for (int p = base + tid; p < m; p += kThreads) {
    cx[p] = 0;
    cy[p] = 0;
    cvalid[p] = 0;
  }
  if (tid == 0) n_dropped[row] = max(base - m, 0);
}

}  // namespace

extern "C" int rep_candidates(const void* x, const void* y, const void* valid, int r, int n,
                              int m, int w1, int off, void* workspace, void* cx, void* cy,
                              void* cvalid, void* n_dropped, void* stream) {
  if (r < 1 || n < 0 || m < 0 || w1 < 1 || n > (1 << 29)) return (int)cudaErrorInvalidValue;
  int log2s = 6;   // at least 64 slots, and at least 2n
  while ((1 << log2s) < 2 * n) ++log2s;
  const size_t smem = workspace ? 0 : ((size_t)(1 << log2s) + n) * sizeof(int32_t);
  static size_t granted = 48 * 1024;   // above it only by opting in
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        rep_candidates_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const auto kernel = workspace ? rep_candidates_kernel<true> : rep_candidates_kernel<false>;
  kernel<<<r, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const uint8_t*>(valid), n, m, w1, off, log2s,
      static_cast<int32_t*>(workspace), static_cast<int32_t*>(cx), static_cast<int32_t*>(cy),
      static_cast<uint8_t*>(cvalid), static_cast<int32_t*>(n_dropped));
  return (int)cudaGetLastError();
}
