// eFAST ring test of candidate events against the SAE time surface.
//
// Replaces no TPU kernel: the JAX package runs this per-candidate test
// (evflow_tpu/ops/efast.py:detect_corners, its 8x8-block gather) as plain
// XLA. It is the q > 1 corner path's detector, run once per sub-slice, and
// its plain PyTorch form (ops/efast.py:_ring_test_plain) took about 137
// launches and two blocking uploads of the ring offsets per call.
//
// Lane i is candidate (x[i], y[i], valid[i]) of snapshot i / m of a stack
// of q (h, w) surfaces (q = 1 outside detect_corners_stacked). Its output is
//   valid && border <= x < sensor_w - border && border <= y < sensor_h - border
//   && both streak tests pass on its 36 ring samples,
// each sample read at (y + i / m * h + dy, x + dx) clamped into the
// (q * h, w) stack, as _ring_test_plain gathers it. The streak test is
// efast_streak.cuh's, shared with the stencil.
//
// What bounds it: at the q=8 path's size, 1,024 lanes per launch, the work
// is 154 bytes per lane (x, y, valid in, 36 int32 samples, the mask out),
// about 0.05 us at the card's bandwidth, far below one launch. So it is
// bound by its latency chain: the coordinate loads, then the sample loads.
// The design:
// - one thread per lane, 64-thread CTAs, so 1,024 lanes spread over 16 SMs;
// - the ring offsets are compile-time constants (the axis order a template
//   argument), so nothing is uploaded and no table is read;
// - a candidate issues its 36 sample loads together (__ldg, the surface is
//   read-only here), so they overlap in one round trip; a lane that is no
//   candidate reads nothing and writes false;
// - the streak bounds are compile-time at the defaults (3..6, 4..8), else
//   every length is scanned, as in the stencil.

#include <cuda_runtime.h>
#include <stdint.h>

#include "efast_streak.cuh"

namespace {

using efast::kR3;
using efast::kR4;
using efast::streak_any;

constexpr int kThreads = 64;

// (dy, dx) in group_track order, circle3's 16 samples then circle4's 20:
// time_surface.at(y + dy, x + dx)
__host__ __device__ constexpr int ring_dy(int k) {
  constexpr int t[kR3 + kR4] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1,
                                0, 1, 2, 3, 4, 4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4,
                                -3, -2, -1};
  return t[k];
}

__host__ __device__ constexpr int ring_dx(int k) {
  constexpr int t[kR3 + kR4] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3,
                                4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4, -3, -2, -1, 0, 1,
                                2, 3, 4};
  return t[k];
}

template <bool kTranspose, int S3LO, int S3HI, int S4LO, int S4HI>
__global__ void __launch_bounds__(kThreads)
efast_ring_kernel(const int32_t* __restrict__ sae, int q, int h, int w,
                  const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const uint8_t* __restrict__ valid, int m, int border,
                  int sensor_w, int sensor_h, int s3min, int s3max, int s4min,
                  int s4max, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q * m) return;
  const int cx = __ldg(x + i), cy = __ldg(y + i);
  bool corner = __ldg(valid + i) != 0 && cx >= border && cx < sensor_w - border &&
                cy >= border && cy < sensor_h - border;
  if (corner) {
    const int row = cy + (i / m) * h, last_row = q * h - 1;
    int ring3[kR3], ring4[kR4];
#pragma unroll
    for (int k = 0; k < kR3 + kR4; ++k) {
      const int dy = kTranspose ? ring_dx(k) : ring_dy(k);
      const int dx = kTranspose ? ring_dy(k) : ring_dx(k);
      const int r = min(max(row + dy, 0), last_row);
      const int c = min(max(cx + dx, 0), w - 1);
      const int32_t v = __ldg(sae + (size_t)r * w + c);
      if (k < kR3)
        ring3[k] = v;
      else
        ring4[k - kR3] = v;
    }
    corner = streak_any<kR3, S3LO, S3HI>(ring3, s3min, s3max) &&
             streak_any<kR4, S4LO, S4HI>(ring4, s4min, s4max);
  }
  out[i] = corner ? 1 : 0;
}

}  // namespace

extern "C" int efast_ring(const void* sae, int q, int h, int w, const void* x,
                          const void* y, const void* valid, int m, int border,
                          int sensor_w, int sensor_h, int s3min, int s3max,
                          int s4min, int s4max, int transpose, void* out,
                          void* stream) {
  if (!efast::streaks_legal(s3min, s3max, s4min, s4max) || q < 1 || h < 1 || w < 1 ||
      m < 1)
    return (int)cudaErrorInvalidValue;
  const bool dflt = s3min == 3 && s3max == 6 && s4min == 4 && s4max == 8;
  const int blocks = (q * m + kThreads - 1) / kThreads;
#define EFAST_RING(T, A, B, C, D)                                               \
  efast_ring_kernel<T, A, B, C, D><<<blocks, kThreads, 0, (cudaStream_t)stream>>>( \
      static_cast<const int32_t*>(sae), q, h, w, static_cast<const int32_t*>(x), \
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(valid), m,       \
      border, sensor_w, sensor_h, s3min, s3max, s4min, s4max,                      \
      static_cast<uint8_t*>(out))
  if (dflt && transpose)
    EFAST_RING(true, 3, 6, 4, 8);
  else if (dflt)
    EFAST_RING(false, 3, 6, 4, 8);
  else if (transpose)
    EFAST_RING(true, 1, kR3 - 1, 1, kR4 - 1);
  else
    EFAST_RING(false, 1, kR3 - 1, 1, kR4 - 1);
#undef EFAST_RING
  return (int)cudaGetLastError();
}
