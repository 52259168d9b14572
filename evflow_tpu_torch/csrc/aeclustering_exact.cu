// The exact AEClustering engine: one slice of the per-event state machine
// in one launch.
//
// Replaces evflow_tpu/models/aeclustering_pallas.py:update_slice_pallas
// (body _make_kernel): per event, forget (chase the expired ring prefix),
// Manhattan match against the live EWMA means, target = first matched
// cluster in deque order, member append, EWMA update (a first member copies
// the pixel), creation in the lowest free slot, merge on >= 2 matches
// (post-add-count weights, member reassignment), empty removal skipped on
// merges, overflow count and last-updated slot. Its plain version is
// evflow_tpu_torch/models/aeclustering.py:update_slice.
//
// What bounds it: per-event latency. Each event is a serial chain of about
// ten warp reductions (match count, target, free slot, the target's count,
// merge sums) plus shared-memory ring traffic, and event i+1 depends on
// event i: one warp is the whole machine, the other SMs idle.
//
// Design: all state stays on chip. One CTA of one warp; each thread owns
// LPT = C/32 cluster lanes (cluster k = j*32 + lane) in registers; the
// member ring lives in shared memory as int32 SoA rows (x, y, t, p, cid),
// 20 KB at M = 1024. Reductions are __shfl_xor_sync / __ballot_sync, so no
// __syncthreads. Index selection is written out: the lowest lane holding
// the minimum key, never an argmin helper.
//
// Bit-equality with the plain version:
// - counts, the match, is_first, the merge weights and the empty test use
//   the live counts at the start of the event, as the plain version's
//   per-event recount does; the ring-full overwrite (eid - tail >= M drops
//   the live tail row) is applied to the counts after them;
// - every f32 rounding is spelled out with __fmul_rn / __fadd_rn /
//   __fdiv_rn / __fmaf_rn, so nvcc contracts nothing on its own. The EWMA
//   is fma(1-a, mu, a*pix), one rounding after the product a*pix, as XLA
//   compiles the JAX package's update_slice (its plain version emulates the
//   FMA exactly); both constants come from the wrapper as f32(1 - a) and
//   f32(a), rounded from double as the plain version rounds them;
// - the merge sum runs over the matched lanes in ascending cluster order.
//   With two matched clusters it is exact in any order; with three or more
//   the plain version's reduction order may differ in the last bit of mu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBig = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// value of cluster k's register among a thread's LPT lanes (0 if not owned)
template <int LPT, typename T>
__device__ __forceinline__ T pick(const T (&v)[LPT], int k, int lane) {
  T r = T(0);
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (j * 32 + lane == k) r = v[j];
  return r;
}

// bit of cluster k in per-register-row ballots
template <int LPT>
__device__ __forceinline__ bool mask_bit(const unsigned (&mask)[LPT], int k) {
  bool r = false;
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (j == (k >> 5)) r = (mask[j] >> (k & 31)) & 1u;
  return r;
}

template <int LPT>
__global__ void __launch_bounds__(32, 1)
aeclustering_exact_kernel(const int* __restrict__ scal,
                          const int* __restrict__ ev,
                          const int* __restrict__ ring_in,
                          const int* __restrict__ ivec,
                          const float* __restrict__ mu_in, int m, int c,
                          float radius, float alpha, float one_minus,
                          int* __restrict__ ring_out, int* __restrict__ ivec_out,
                          float* __restrict__ mu_out, int* __restrict__ scal_out) {
  extern __shared__ int smem[];
  int* const rt = smem + 2 * m;     // member times
  int* const rc = smem + 4 * m;     // member cluster slots
  const int lane = threadIdx.x;
  for (int r = lane; r < 5 * m; r += 32) smem[r] = ring_in[r];

  int alive[LPT], corder[LPT], cid[LPT], nc[LPT];
  float mux[LPT], muy[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int k = j * 32 + lane;
    const bool in = k < c;
    alive[j] = in ? ivec[k] : 0;
    corder[j] = in ? ivec[c + k] : kBig;
    cid[j] = in ? ivec[2 * c + k] : -1;
    nc[j] = in ? ivec[3 * c + k] : 0;
    mux[j] = in ? mu_in[2 * k] : 0.f;
    muy[j] = in ? mu_in[2 * k + 1] : 0.f;
  }
  int tail = scal[0], eid = scal[1], nord = scal[2], ncid = scal[3];
  int lupd = scal[4], ovf = scal[5];
  const int n_eff = scal[6];
  __syncwarp();

  for (int i = 0; i < n_eff; ++i) {
    const int4 e0 = *reinterpret_cast<const int4*>(ev + 8 * i);      // x y t p
    const int2 e1 = *reinterpret_cast<const int2*>(ev + 8 * i + 4);  // valid tmin
    const bool vi = e1.x > 0;
    const int tmini = e1.y;

    // ---- forget: members older than tMin form a ring prefix; chase it
    while (tail < eid) {
      const int r = floor_mod(tail, m);
      if (!(rt[r] < tmini)) break;
      const int gone = rc[r];
#pragma unroll
      for (int j = 0; j < LPT; ++j) nc[j] -= (j * 32 + lane == gone);
      ++tail;
    }

    // ---- match against the live means; target = lowest creation order
    const float fx = static_cast<float>(e0.x), fy = static_cast<float>(e0.y);
    bool near[LPT], empty[LPT];
    unsigned nearm[LPT];
    int n_assigned = 0, bkey = kBig, bidx = c, free_slot = c;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int k = j * 32 + lane;
      const float d = __fadd_rn(fabsf(__fsub_rn(fx, mux[j])), fabsf(__fsub_rn(fy, muy[j])));
      near[j] = alive[j] && nc[j] > 0 && d <= radius;
      empty[j] = alive[j] && nc[j] == 0;
      nearm[j] = __ballot_sync(kFull, near[j]);
      n_assigned += __popc(nearm[j]);
      if (near[j] && corder[j] < bkey) {   // k ascends with j: lowest lane on ties
        bkey = corder[j];
        bidx = k;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const int ok = __shfl_xor_sync(kFull, bkey, o);
      const int oi = __shfl_xor_sync(kFull, bidx, o);
      if (ok < bkey || (ok == bkey && oi < bidx)) {
        bkey = ok;
        bidx = oi;
      }
    }
#pragma unroll
    for (int j = LPT - 1; j >= 0; --j) {
      const unsigned fm = __ballot_sync(kFull, !alive[j] && j * 32 + lane < c);
      if (fm) free_slot = j * 32 + __ffs(fm) - 1;
    }
    const bool any_a = n_assigned > 0;
    const bool have_free = free_slot < c;
    const bool make_new = vi && !any_a && have_free;
    ovf += (vi && !any_a && !have_free);
    const int target = any_a ? bidx : free_slot;
    const bool do_add = vi && (any_a || make_new);
    const int nc_t = __shfl_sync(kFull, pick<LPT>(nc, target, lane), target & 31);
    const bool is_first = any_a ? nc_t == 0 : true;

    // ---- EWMA mean of the target, then creation bookkeeping
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int k = j * 32 + lane;
      if (do_add && k == target) {
        mux[j] = is_first ? fx : __fmaf_rn(one_minus, mux[j], __fmul_rn(alpha, fx));
        muy[j] = is_first ? fy : __fmaf_rn(one_minus, muy[j], __fmul_rn(alpha, fy));
      }
      if (make_new && k == free_slot) {
        alive[j] = 1;
        corder[j] = nord;
        cid[j] = ncid;
      }
    }
    nord += make_new;
    ncid += make_new;

    // ---- merge (>= 2 matches): weights = counts after this event's add,
    // summed in ascending cluster order
    const bool do_merge = vi && n_assigned >= 2;
    if (do_merge) {
      float px[LPT], py[LPT];
      int wsum = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int w = near[j] ? nc[j] + (j * 32 + lane == target) : 0;
        wsum += w;
        px[j] = __fmul_rn(static_cast<float>(w), mux[j]);
        py[j] = __fmul_rn(static_cast<float>(w), muy[j]);
      }
      const float den = fmaxf(static_cast<float>(warp_sum(wsum)), 1.f);
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        for (unsigned mk = nearm[j]; mk; mk &= mk - 1) {
          const int src = __ffs(mk) - 1;
          ax = __fadd_rn(ax, __shfl_sync(kFull, px[j], src));
          ay = __fadd_rn(ay, __shfl_sync(kFull, py[j], src));
        }
      }
      const float gx = __fdiv_rn(ax, den), gy = __fdiv_rn(ay, den);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (j * 32 + lane == target) {
          mux[j] = gx;
          muy[j] = gy;
        } else if (near[j]) {
          alive[j] = 0;
        }
      }
    }

    // ---- remove empties (skipped on merge updates, AEClustering.cpp:104)
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      if (vi && !do_merge && empty[j]) alive[j] = 0;

    // ---- ring: a full ring loses its live tail row, then the append
    if (do_add) {
      const int slot = floor_mod(eid, m);
      if (eid - tail >= m) {
        const int gone = rc[slot];
#pragma unroll
        for (int j = 0; j < LPT; ++j) nc[j] -= (j * 32 + lane == gone);
        ++tail;
      }
      __syncwarp();
      if (lane == 0) {
        smem[slot] = e0.x;
        smem[m + slot] = e0.y;
        rt[slot] = e0.z;
        smem[3 * m + slot] = e0.w;
        rc[slot] = target;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < LPT; ++j) nc[j] += (j * 32 + lane == target);
      ++eid;
    }

    // ---- merge: the matched clusters' rows (expired ones too) and counts
    // move to the target
    if (do_merge) {
      int tot = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) tot += near[j] ? nc[j] : 0;
      tot = warp_sum(tot);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (j * 32 + lane == target) nc[j] = tot;
        else if (near[j]) nc[j] = 0;
      }
      for (int r = lane; r < m; r += 32) {
        const int k = rc[r];
        if (k >= 0 && mask_bit<LPT>(nearm, k)) rc[r] = target;
      }
      __syncwarp();
    }

#pragma unroll
    for (int j = 0; j < LPT; ++j)
      if (!alive[j]) corder[j] = kBig;
    if (vi) lupd = do_add ? target : -1;
  }

  __syncwarp();
  for (int r = lane; r < 5 * m; r += 32) ring_out[r] = smem[r];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int k = j * 32 + lane;
    if (k < c) {
      ivec_out[k] = alive[j];
      ivec_out[c + k] = corder[j];
      ivec_out[2 * c + k] = cid[j];
      ivec_out[3 * c + k] = nc[j];
      mu_out[2 * k] = mux[j];
      mu_out[2 * k + 1] = muy[j];
    }
  }
  if (lane == 0) {
    const int out[8] = {tail, eid, nord, ncid, lupd, ovf, 0, 0};
    for (int s = 0; s < 8; ++s) scal_out[s] = out[s];
  }
}

template <int LPT>
cudaError_t launch(const int* scal, const int* ev, const int* ring_in,
                   const int* ivec, const float* mu_in, int m, int c,
                   float radius, float alpha, float one_minus, int* ring_out,
                   int* ivec_out, float* mu_out, int* scal_out,
                   cudaStream_t stream) {
  const size_t smem = 5 * sizeof(int) * (size_t)m;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        aeclustering_exact_kernel<LPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  aeclustering_exact_kernel<LPT><<<1, 32, smem, stream>>>(
      scal, ev, ring_in, ivec, mu_in, m, c, radius, alpha, one_minus,
      ring_out, ivec_out, mu_out, scal_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aeclustering_exact(const void* scal, const void* ev,
                                  const void* ring_in, const void* ivec,
                                  const void* mu_in, int m, int c, float radius,
                                  float alpha, float one_minus, void* ring_out,
                                  void* ivec_out, void* mu_out, void* scal_out,
                                  void* stream) {
  if (c < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const int lpt = (c + 31) / 32;
#define AE_LAUNCH(L)                                                          \
  return (int)launch<L>(static_cast<const int*>(scal),                       \
                        static_cast<const int*>(ev),                         \
                        static_cast<const int*>(ring_in),                    \
                        static_cast<const int*>(ivec),                       \
                        static_cast<const float*>(mu_in), m, c, radius,      \
                        alpha, one_minus, static_cast<int*>(ring_out),       \
                        static_cast<int*>(ivec_out),                         \
                        static_cast<float*>(mu_out),                         \
                        static_cast<int*>(scal_out), (cudaStream_t)stream)
  if (lpt <= 1) AE_LAUNCH(1);
  if (lpt <= 2) AE_LAUNCH(2);
  if (lpt <= 4) AE_LAUNCH(4);
  if (lpt <= 8) AE_LAUNCH(8);
#undef AE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
