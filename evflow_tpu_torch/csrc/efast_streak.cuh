// The eFAST streak test on one ring of samples held in registers, shared by
// csrc/efast_stencil.cu (every pixel of the active tiles) and
// csrc/efast_ring.cu (one candidate per thread), so the two cannot drift.
//
// Some start i and length s in [smin, smax] pass if
//   min(ring[i .. i+s-1]) > max(ring[i+s .. i+R-1])   (indices mod R);
// efast.py:_streak_any's two boundary conditions follow from it. A ring with
// fewer than smin values above its minimum is rejected at once. Otherwise
// the scan costs about R (SHI - SLO + 1) compares: the off-arc maximum for
// the longest length, max(ring[i+SHI .. i+R-1]), comes for all starts from a
// doubling sliding maximum, and per start the arc minimum grows and the
// off-arc maximum shrinks one sample per length. The lengths scanned,
// [SLO, SHI], are compile-time and hold [smin, smax]; each is tested against
// the configured range at run time. ops/efast.py:streak_any_scan is this
// arithmetic on the CPU.

#pragma once

namespace efast {

constexpr int kR3 = 16;   // samples on circle3
constexpr int kR4 = 20;   // samples on circle4

__host__ __device__ constexpr int log2_floor(int v) { return v >= 2 ? 1 + log2_floor(v / 2) : 0; }

template <int R, int SLO, int SHI>
__device__ __forceinline__ bool streak_any(const int (&ring)[R], int smin, int smax) {
  static_assert(1 <= SLO && SLO <= SHI && SHI < R, "lengths outside the ring");

  int lo = ring[0];
#pragma unroll
  for (int k = 1; k < R; ++k) lo = min(lo, ring[k]);
  int above = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) above += ring[k] > lo;
  if (above < smin) return false;

  // om[i] = max(ring[i+SHI .. i+R-1]): a window of L samples, as the max of
  // two windows of P <= L samples from a doubling sliding maximum
  constexpr int L = R - SHI;
  constexpr int kLevels = log2_floor(L);
  constexpr int P = 1 << kLevels;
  int wmax[R];
#pragma unroll
  for (int k = 0; k < R; ++k) wmax[k] = ring[k];
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int p = 1 << lvl;
    int nxt[R];
#pragma unroll
    for (int k = 0; k < R; ++k) nxt[k] = max(wmax[k], wmax[(k + p) % R]);
#pragma unroll
    for (int k = 0; k < R; ++k) wmax[k] = nxt[k];
  }

  bool found = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int amin[SHI - SLO + 1];   // amin[s - SLO] = min(ring[i .. i+s-1])
    int a = ring[i];
#pragma unroll
    for (int s = 1; s < SLO; ++s) a = min(a, ring[(i + s) % R]);
    amin[0] = a;
#pragma unroll
    for (int s = SLO + 1; s <= SHI; ++s) {
      a = min(a, ring[(i + s - 1) % R]);
      amin[s - SLO] = a;
    }
    int off = max(wmax[(i + SHI) % R], wmax[(i + SHI + L - P) % R]);
#pragma unroll
    for (int s = SHI; s >= SLO; --s) {
      if (s < SHI) off = max(off, ring[(i + s) % R]);
      found |= (s >= smin) & (s <= smax) & (amin[s - SLO] > off);
    }
  }
  return found;
}

// the streak bounds the kernels take: lengths inside each ring
__host__ __device__ constexpr bool streaks_legal(int s3min, int s3max, int s4min, int s4max) {
  return 1 <= s3min && s3min <= s3max && s3max < kR3 && 1 <= s4min && s4min <= s4max &&
         s4max < kR4;
}

}  // namespace efast
