// Per-slice cluster statistics with stream-order EWMA weights.
//
// Replaces evflow_tpu/ops/pallas_kernels.py:cluster_stats (the Pallas kernel
// _cluster_stats_kernel), i.e. fastcluster steps 3-4 (fastcluster.py:
// 361-369): for labels (N,) int32 (-1 = none) and x, y (N,) f32, the (C, 5)
// f32 rows [k, sum x, sum y, sum w x, sum w y], where k is the cluster's
// member count, rank the member's stream-order position within its cluster
// and w = alpha * (1 - alpha)^clip(k - 1 - rank, 0, 80). Labels outside
// [0, C) belong to no cluster.
//
// An optional (C,) int32 k_after counts each cluster's members in the
// tiles that follow this one in tile-major order (the tiled update,
// models/fastcluster.py:update_slice_distributed): the members' ranks are
// then global, and the exponent is k + k_after - 1 - rank. The rows keep
// this call's own counts and sums; the caller all-reduces them. Null: no
// later tiles, the same code as without the argument.
//
// What bounds it on an H100: at the main path's size (N = 16384, C = 128)
// the function moves 12 bytes per event and 20 per cluster, 0.2 MB, about
// 0.06 us at 3.35 TB/s; its arithmetic is a few ops per event. Both are far
// below the time of a launch, so the kernel is bound by its chain of
// dependent steps: the loads' latency, the barriers, and how many times
// the events are walked. (The previous design ran one CTA per cluster, each
// walking all N labels twice in 256-label chunks with a barrier per chunk:
// ~16 MB of L2 traffic and a serial chain of ~128 barriers per slice.)
//
// Design: ONE thread-block cluster of 8 CTAs (the portable size) of 512
// threads, on 8 SMs. CTA r owns the r-th contiguous eighth of the events,
// in stream order, and walks it in chunks of a fixed size (as many events
// as its shared memory holds beside the per-cluster arrays, at most 16384),
// staging each chunk with 16-byte loads (a masked tail). No atomics:
//   1. each of W ranking warps walks a contiguous piece of the chunk, 32
//      events a step; __match_any_sync groups a step's equal labels (four
//      steps matched ahead), so a member's rank within its warp is the
//      warp's running count of the label plus its peers on lower lanes:
//      stream order;
//   2. per cluster, an exclusive sum over the warps' counts gives each
//      warp's offset and the chunk's count, added to the CTA's count; a
//      block-wide scan over clusters gives each cluster's bucket in a
//      counting sort of the chunk's members;
//   3. the cluster barrier that publishes the CTA's counts is split; where
//      the range is one chunk, each member goes to its bucket at its rank
//      between the arrive and the wait, so a cluster's members sit
//      contiguous and in stream order; only the warps that wrote counts
//      arrive with release semantics (a fence at cluster scope), and the
//      others sort while they fence;
//   4. each CTA reads the other CTAs' counts through distributed shared
//      memory (map_shared_rank): the lower ranks' give its offsets, all
//      eight give k, so the exponent of the CTA's first member is known
//      (k_after[j] added where given);
//   5. chunk by chunk (a range of more chunks stages, ranks and sorts each
//      again), a warp per cluster sums its bucket lane-strided, with
//      weights from a table of alpha (1 - alpha)^e for e = 0..80 (the
//      exponent counts down from the CTA's first member), and a fixed
//      6-shuffle reduction, into the CTA's (sum x, sum y, sum w x, sum w y)
//      partial of the cluster; then the CTA sends each partial to the
//      landing row of CTA j mod 8 with st.async, whose 16 bytes complete on
//      that CTA's mbarrier (a CTA that gathers no cluster gets one dummy
//      row);
//   6. each CTA waits on its own mbarrier for the rows of every other CTA
//      (so none of them reads its counts any more when it exits), adds the
//      eight partials of each of its clusters in rank order and writes
//      those (C, 5) rows.
// Where a CTA's range is one chunk (N up to 8 x 15,792 = 126,336 at
// C = 128, 8 x 1168 = 9344 at C = 4096), every label, x and y is read
// once, by a build of the kernel without the second pass's staging; a
// longer range reads its labels twice (counts first, then the sums) and
// x, y once. Each thread starts its first loads before it zeroes the
// warps' counts, which run in their shadow. One cluster barrier, split,
// and one mbarrier cross the cluster: the cluster barrier's release is a
// fence at cluster scope, st.async needs none. A cluster with no members
// costs its zero row. No float atomics: the summation order is fixed, so
// two calls on the same input give the same bits. Counts and ranks are
// exact integers; sum x and sum y add integer-valued f32, exact in any
// order below 2^24; only the weighted sums depend on the f32 order.
// expf/log1pf in f32 (the weight table), no fast-math.
//
// Shared memory per CTA, with Cp = C rounded up to 4, G = ceil(Cp/8)
// clusters gathered per CTA, W ranking warps and a chunk of H events:
// (32 + 2W) Cp + 128 G + 4 G (G rounded up to 4) + 14 H bytes (per
// cluster: CTA count, chunk count, bucket start, running exponent, the
// float4 partial and W 16-bit warp counts; a float4 landing row from each
// CTA and k per gathered cluster; per event: label, x, y and a 16-bit sort
// index). The host entry point takes W = 16, halved while the per-cluster
// arrays and a chunk of 1024 events do not fit, and the largest chunk that
// fits (capped at the CTA's range): at C = 128 and N = 16384, W = 16,
// H = 2048 and 38,976 bytes; at C = 4096 and N = 16384, W = 2, H = 1168 and
// 231,392 of the 231,424 it allows itself. Any N fits; C up to
// cluster_kernels.MAX_CLUSTERS (4096) does.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;          // CTAs in the thread-block cluster
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;         // 32-event steps a ranking warp matches ahead
constexpr int kLabelBits = 13;    // a ranked label packs
constexpr int kWarpBits = 4;      // (rank << 17) | (warp << 13) | label
constexpr int kMaxChunk = 16384;  // ranks stay below 2^14, sort indices 16-bit
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a CTA may take (227 KB) less a margin for the
// static arrays
constexpr size_t kSmemLimit = 232448 - 1024;

// bytes of dynamic shared memory besides the chunk, for cp clusters and rw
// ranking warps: four ints, a float4 partial and rw 16-bit warp counts per
// cluster, then a float4 landing row from each CTA and k per gathered
// cluster
size_t cluster_bytes(int cp, int rw) {
  const size_t own = (cp + kCtas - 1) / kCtas;
  return (size_t)(32 + 2 * rw) * cp + 16 * kCtas * own + 4 * ((own + 3) / 4 * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t remote(const void* p, int cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(cta));
  return r;
}

// store a float4 at the same shared address in CTA `cta`, asynchronously;
// its 16 bytes complete on that CTA's mbarrier at the address of `bar`
__device__ __forceinline__ void send_row(float4* row, float4 v, const uint64_t* bar, int cta) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(remote(row, cta)), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
                  "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(remote(bar, cta))
               : "memory");
}

__device__ __forceinline__ void wait_phase0(const uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(bar)) : "memory");
}

// The four sums of a warp in 6 shuffles rather than 20: halves of the warp
// trade halves of the values, then each lane group of 8 reduces one value.
// Lane 8 q ends with the warp's sum of value q. A fixed order: deterministic.
__device__ __forceinline__ float warp_sum4(float v0, float v1, float v2, float v3,
                                           int lane) {
  const bool hi = lane & 16, h8 = lane & 8;
  const float r0 = __shfl_xor_sync(kFull, hi ? v0 : v2, 16);
  const float r1 = __shfl_xor_sync(kFull, hi ? v1 : v3, 16);
  const float a0 = (hi ? v2 : v0) + r0, a1 = (hi ? v3 : v1) + r1;
  float b = (h8 ? a1 : a0) + __shfl_xor_sync(kFull, h8 ? a0 : a1, 8);
  b += __shfl_xor_sync(kFull, b, 4);
  b += __shfl_xor_sync(kFull, b, 2);
  b += __shfl_xor_sync(kFull, b, 1);
  return b;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int own(int label, int c) {
  return label >= 0 && label < c ? label : -1;
}

// The shared arrays of one CTA (see the head note for their sizes).
struct Smem {
  float4* part;      // [cp] the CTA's partial sums per cluster
  float4* land;      // [kCtas][own_max] partials landed from each CTA
  int* cnt;          // [cp] the CTA's members per cluster (read remotely)
  int* chk;          // [cp] the chunk's members per cluster
  int* bucket;       // [cp] bucket start in the chunk's sort
  int* erun;         // [cp] exponent of the chunk's first member, unclamped
  int* ktot;         // [own_max] k of each gathered cluster
  int* lab;          // [ch] label, then packed (rank, warp, label)
  float* xs;         // [ch]
  float* ys;         // [ch]
  uint16_t* wcnt;    // [rw][cp] ranking warps' counts, then offsets
  uint16_t* order;   // [ch] chunk index of each sorted member
};

// Stage `len` events from `lo` (a multiple of 4): labels (outside [0, C)
// as -1), and x and y where `xy`; 16-byte loads, each thread's all in
// flight before its stores, and scalar ones for the tail or unaligned
// inputs.
// Zero the ranking warps' counts.
__device__ __forceinline__ void stage(const Smem& s, const int32_t* __restrict__ labels,
                                      const float* __restrict__ x,
                                      const float* __restrict__ y, int lo, int len, bool xy,
                                      int c, int cp, int rw) {
  const int tid = threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(labels) | reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int nvec = vec ? len / 4 : 0;
  // the first loads start before the counts are zeroed, so the zeroing
  // runs while they are in flight
  for (int v0 = 0; v0 == 0 || v0 < nvec; v0 += kThreads) {
    const int v = v0 + tid;
    int4 l;
    float4 a, b;
    if (v < nvec) {
      l = reinterpret_cast<const int4*>(labels + lo)[v];
      if (xy) {
        a = reinterpret_cast<const float4*>(x + lo)[v];
        b = reinterpret_cast<const float4*>(y + lo)[v];
      }
    }
    if (v0 == 0)
      for (int i = tid; i < rw * cp / 2; i += kThreads) reinterpret_cast<int*>(s.wcnt)[i] = 0;
    if (v < nvec) {
      reinterpret_cast<int4*>(s.lab)[v] = make_int4(own(l.x, c), own(l.y, c), own(l.z, c),
                                                    own(l.w, c));
      if (xy) {
        reinterpret_cast<float4*>(s.xs)[v] = a;
        reinterpret_cast<float4*>(s.ys)[v] = b;
      }
    }
  }
  for (int i = 4 * nvec + tid; i < len; i += kThreads) {
    const int l = labels[lo + i];
    const float a = xy ? x[lo + i] : 0.f, b = xy ? y[lo + i] : 0.f;
    s.lab[i] = own(l, c);
    if (xy) {
      s.xs[i] = a;
      s.ys[i] = b;
    }
  }
}

// 1. rank within each ranking warp's contiguous sub-range of the chunk, in
// stream order: kSteps steps of 32 events are matched at once, then the
// warp's running counts advance step by step
__device__ __forceinline__ void rank_chunk(const Smem& s, int len, int cp, int rw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= rw) return;
  const int t = (len + rw - 1) / rw;
  uint16_t* wc = s.wcnt + warp * cp;
  const int end = min(len, (warp + 1) * t);
  const unsigned lower = (1u << lane) - 1u;
  for (int b = warp * t; b < end; b += 32 * kSteps) {
    int l[kSteps];
    unsigned peers[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int i = b + 32 * k + lane;
      l[k] = i < end ? s.lab[i] : -1;
      peers[k] = __match_any_sync(kFull, l[k]);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int prev = l[k] >= 0 ? wc[l[k]] : 0;
      __syncwarp();
      if (l[k] >= 0 && (peers[k] & lower) == 0) wc[l[k]] = (uint16_t)(prev + __popc(peers[k]));
      __syncwarp();
      if (l[k] >= 0)
        s.lab[b + 32 * k + lane] = ((prev + __popc(peers[k] & lower)) << (kLabelBits + kWarpBits)) |
                                   (warp << kLabelBits) | l[k];
    }
  }
}

// 2. per cluster (a contiguous run of q clusters per thread): the ranking
// warps' offsets and the chunk's count (the CTA's count where `count`,
// added to the earlier chunks' unless `first`), then the buckets by a
// block-wide scan
__device__ __forceinline__ void scan_chunk(const Smem& s, int* warp_tot, int cp, int rw,
                                           bool count, bool first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (cp + kThreads - 1) / kThreads;
  const int j0 = min(cp, tid * q), j1 = min(cp, j0 + q);
  int run = 0;
  for (int j = j0; j < j1; ++j) {
    int sum = 0;
    for (int w0 = 0; w0 < rw; w0 += 8) {   // eight loads in flight, then the stores
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = w0 + u < rw ? s.wcnt[(w0 + u) * cp + j] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (w0 + u < rw) s.wcnt[(w0 + u) * cp + j] = (uint16_t)sum;
        sum += v[u];
      }
    }
    s.chk[j] = sum;
    if (count) s.cnt[j] = (first ? 0 : s.cnt[j]) + sum;
    run += sum;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int start = incl - run;
  for (int w = 0; w < warp; ++w) start += warp_tot[w];
  for (int j = j0; j < j1; ++j) {
    s.bucket[j] = start;
    start += s.chk[j];
  }
}

// 3. the counting sort of the chunk's members, by threads first, first +
// step, ...: a member's place is its bucket, its warp's offset, its rank
__device__ __forceinline__ void sort_chunk(const Smem& s, int len, int cp, int first, int step) {
  for (int i = first; i < len; i += step) {
    const int v = s.lab[i];
    if (v >= 0) {
      const int l = v & ((1 << kLabelBits) - 1);
      const int w = (v >> kLabelBits) & ((1 << kWarpBits) - 1);
      s.order[s.bucket[l] + s.wcnt[w * cp + l] + (v >> (kLabelBits + kWarpBits))] = (uint16_t)i;
    }
  }
}

// 5. a warp per cluster sums the chunk's bucket in a fixed order into the
// CTA's partial; the exponents then count on from the chunk's end
__device__ __forceinline__ void sum_chunk(const Smem& s, const float* wpow, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < c; j += kWarps) {
    const int m = s.chk[j];
    if (m == 0) continue;
    const int b = s.bucket[j], e = s.erun[j];
    float sx = 0.f, sy = 0.f, swx = 0.f, swy = 0.f;
#pragma unroll 2
    for (int p = lane; p < m; p += 32) {
      const int i = s.order[b + p];
      const float xi = s.xs[i], yi = s.ys[i];
      const float wgt = wpow[min(max(e - p, 0), 80)];
      sx += xi;
      sy += yi;
      swx += wgt * xi;
      swy += wgt * yi;
    }
    const float v = warp_sum4(sx, sy, swx, swy, lane);
    if ((lane & 7) == 0)   // lane 8 q holds value q
      reinterpret_cast<float*>(s.part + j)[lane >> 3] += v;
    __syncwarp();
    if (lane == 0) s.erun[j] = e - m;
  }
}

template <bool kChunked>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads)
cluster_stats_kernel(const int32_t* __restrict__ labels,
                     const float* __restrict__ x, const float* __restrict__ y,
                     const int32_t* __restrict__ k_after,
                     int n, int c, int cp, int per_cta, int ch, int rw, float alpha,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int own_max = (cp + kCtas - 1) / kCtas;
  Smem s;
  s.part = reinterpret_cast<float4*>(smem);
  s.land = s.part + cp;
  s.cnt = reinterpret_cast<int*>(s.land + kCtas * own_max);
  s.chk = s.cnt + cp;
  s.bucket = s.chk + cp;
  s.erun = s.bucket + cp;
  s.ktot = s.erun + cp;
  s.lab = s.ktot + (own_max + 3) / 4 * 4;
  s.xs = reinterpret_cast<float*>(s.lab + ch);
  s.ys = s.xs + ch;
  s.wcnt = reinterpret_cast<uint16_t*>(s.ys + ch);
  s.order = s.wcnt + rw * cp;
  __shared__ int warp_tot[kWarps];
  __shared__ float wpow[81];          // alpha (1 - alpha)^e, e = 0..80
  __shared__ __align__(8) uint64_t land_bar;   // the landing rows are in

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lo = min(n, rank * per_cta);
  const int len = min(n, lo + per_cta) - lo;
  const int nch = kChunked ? (len + ch - 1) / ch : len > 0;
  // this CTA gathers clusters rank, rank + 8, ...; each CTA arrives once
  // on its mbarrier, when its partials have landed and it reads no more
  const int n_own = rank < c ? (c - rank + kCtas - 1) / kCtas : 0;
  if (tid == kThreads - 1) {   // a thread with no weight to tabulate
    // the landing rows arrive by st.async, each completing its bytes on
    // this mbarrier: one row from each other CTA per gathered cluster (one
    // dummy row where this CTA gathers none); this CTA's own rows are
    // plain stores
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&land_bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
                 :: "r"(smem_u32(&land_bar)), "r"(16 * (kCtas - 1) * max(n_own, 1)) : "memory");
  }
  const int q = (cp + kThreads - 1) / kThreads;   // clusters per thread in step 2
  if (tid <= 80) wpow[tid] = alpha * expf(static_cast<float>(tid) * log1pf(-alpha));
  if (len == 0)   // no chunk: step 2 does not zero the counts
    for (int j = min(cp, tid * q); j < min(cp, tid * q + q); ++j) s.cnt[j] = 0;

  // pass 1: the CTA's counts, chunk by chunk; a range of one chunk stages
  // x and y too, and keeps its ranks for the sums
  for (int k = 0; k < nch; ++k) {
    const int clen = min(ch, len - k * ch);
    stage(s, labels, x, y, lo + k * ch, clen, nch == 1, c, cp, rw);
    __syncthreads();
    rank_chunk(s, clen, cp, rw);
    __syncthreads();
    scan_chunk(s, warp_tot, cp, rw, true, k == 0);
    __syncthreads();
  }

  // 3. the counting sort of a one-chunk range needs only this CTA's data:
  // it runs between the arrive and the wait of the cluster barrier that
  // publishes the counts. Only the warps that wrote counts arrive with
  // release semantics (a fence at cluster scope); the others arrive relaxed
  // and sort meanwhile, unless every warp wrote counts.
  const int writers = min(kThreads, (cp + q - 1) / q + 31) / 32 * 32;   // whole warps
  const int sorters = writers < kThreads ? kThreads - writers : kThreads;
  if (tid < writers)
    cluster_arrive();
  else
    cluster_arrive_relaxed();
  if (nch == 1 && (sorters == kThreads || tid >= writers))
    sort_chunk(s, len, cp, sorters < kThreads ? tid - writers : tid, sorters);
  cluster_wait();

  // 4. every CTA's counts are in place: offsets and k through DSMEM
  for (int j = tid; j < c; j += kThreads) {
    int off = 0, k = 0;
#pragma unroll
    for (int r = 0; r < kCtas; ++r) {
      const int v = cluster.map_shared_rank(s.cnt, r)[j];
      off += r < rank ? v : 0;
      k += v;
    }
    // unclamped here, clamped to [0, 80] where the weight is looked up
    s.erun[j] = k - 1 - off + (k_after ? k_after[j] : 0);
    if (j % kCtas == rank) s.ktot[j / kCtas] = k;
    s.part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // pass 2: the sums, chunk by chunk; a range of more chunks stages, ranks
  // and sorts each again
  for (int k = 0; k < nch; ++k) {
    if (kChunked && nch > 1) {
      const int clen = min(ch, len - k * ch);
      stage(s, labels, x, y, lo + k * ch, clen, true, c, cp, rw);
      __syncthreads();
      rank_chunk(s, clen, cp, rw);
      __syncthreads();
      scan_chunk(s, warp_tot, cp, rw, false, false);
      __syncthreads();
      sort_chunk(s, clen, cp, tid, kThreads);
      __syncthreads();
    }
    sum_chunk(s, wpow, c);
    __syncthreads();
  }

  // the partials to the landing rows of the CTAs that gather them
  for (int j = tid; j < c; j += kThreads) {
    const int dst = j % kCtas, row = rank * own_max + j / kCtas;
    if (dst == rank)
      s.land[row] = s.part[j];
    else
      send_row(s.land + row, s.part[j], &land_bar, dst);
  }
  if (tid < kCtas && tid >= c && tid != rank)   // a CTA that gathers none
    send_row(s.land + rank * own_max, make_float4(0.f, 0.f, 0.f, 0.f), &land_bar, tid);

  // 6. the eight partials of each gathered cluster, in rank order; every
  // other CTA's rows have landed, so none of them reads this CTA's counts
  // any more when it exits
  wait_phase0(&land_bar);
  __syncthreads();
  for (int g = tid; g < n_own; g += kThreads) {
    const int j = rank + kCtas * g;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kCtas; ++r) {
      const float4 v = s.land[r * own_max + g];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    float* o = out + 5 * (size_t)j;
    o[0] = static_cast<float>(s.ktot[g]);
    o[1] = acc.x;
    o[2] = acc.y;
    o[3] = acc.z;
    o[4] = acc.w;
  }
}

}  // namespace

extern "C" int cluster_stats(const void* labels, const void* x, const void* y,
                             int n, int c, float alpha, const void* k_after, void* out,
                             void* stream) {
  if (c < 1 || c > (1 << kLabelBits)) return (int)cudaErrorInvalidValue;
  const int cp = (c + 3) / 4 * 4;
  const int per_cta = 4 * ((n + 4 * kCtas - 1) / (4 * kCtas));   // a multiple of 4
  int rw = kWarps;   // as many ranking warps as leave room for a chunk of 1024
  while (rw > 1 && cluster_bytes(cp, rw) + 14 * 1024 > kSmemLimit) rw /= 2;
  const size_t fixed = cluster_bytes(cp, rw);
  if (fixed + 14 * 4 > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int cap = (int)std::min<size_t>((kSmemLimit - fixed) / 14 / 4 * 4, kMaxChunk);
  const int ch = std::max(4, std::min(per_cta, cap));   // events per chunk
  const size_t smem = fixed + 14 * (size_t)ch;
  // a range of one chunk (the main path's) takes the kernel built without
  // the second pass's staging, ranking and sorting
  const bool chunked = per_cta > ch;
  const auto kernel = chunked ? cluster_stats_kernel<true> : cluster_stats_kernel<false>;
  static size_t granted[2] = {48 * 1024, 48 * 1024};   // above it only by opting in
  if (smem > granted[chunked]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[chunked] = smem;
  }
  kernel<<<kCtas, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(labels), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const int32_t*>(k_after), n, c, cp, per_cta,
      ch, rw, alpha, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
