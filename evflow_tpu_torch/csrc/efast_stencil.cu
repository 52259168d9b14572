// eFAST corner mask over (band x wtile) tiles of the SAE time surface.
//
// Replaces evflow_tpu/ops/efast.py:corner_mask_dense_pallas_sparse2 (the
// tile-predicated Pallas stencil on the main path). With a band map
// broadcast over the tiles it also replaces corner_mask_dense_pallas_sparse,
// and with an all-ones map corner_mask_dense_pallas.
//
// The test per pixel is the one of efast.py:_streak_any: on circle3 (16
// ring samples) and circle4 (20), some start i and arc length s in
// [smin, smax] with
//   ring[i] >= ring[i-1],  ring[i+s-1] >= ring[i+s],
//   min(ring[i .. i+s-1]) > max(ring[i+s .. i+R-1])   (indices mod R).
// The third condition implies the first two (ring[i-1] and ring[i+s] lie
// off the arc), so only it is tested. Pixels within `border` of the sensor
// edge are False.
//
// What bounds it: integer operations on the active tiles; the SAE read is
// a few MB. A slice activates few tiles (22 of 300 on the DEFAULT stream).
// The design:
// - one CTA per kRows rows of a tile, so a slice's ~20 active tiles make
//   ~200 CTAs and fill the card's 132 SMs; an inactive CTA zero-fills its
//   rows with 16-byte stores and exits, with no host sync;
// - an active CTA stages its (kRows+8) x (wtile+8) int32 halo in shared
//   memory, zeros outside the image as jnp.pad gives; each thread holds its
//   pixel's ring in registers (the circle offsets are constant-bank
//   operands, the axis order a template argument);
// - per ring, a pixel whose ring has fewer than smin values above its
//   minimum is rejected at once (the arc must be strictly newer than every
//   off-arc sample), which clears untouched neighbourhoods;
// - otherwise the scan costs about R (smax - smin + 1) compares: the off-
//   arc maximum for the longest length, max(ring[i+SHI .. i+R-1]), comes for
//   all starts from a doubling sliding maximum, and per start the arc
//   minimum grows and the off-arc maximum shrinks one sample per length.
//   The lengths scanned, [SLO, SHI], are compile-time: [smin, smax] at the
//   default bounds (3..6 and 4..8), else [1, R-1]; each is tested against
//   the configured range at run time.
// The streak test is efast_streak.cuh's, shared with csrc/efast_ring.cu.
// ops/efast.py:streak_any_scan is this arithmetic on the CPU; the tests
// hold it to _streak_any and the JAX package's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "efast_streak.cuh"

namespace {

using efast::kR3;
using efast::kR4;
using efast::streak_any;

constexpr int kThreads = 256;
constexpr int kRows = 2;     // tile rows per CTA
constexpr int kHalo = 4;

// (dy, dx) in group_track order: time_surface.at(y + c[i][0], x + c[i][1])
__constant__ int kCircle3[kR3][2] = {
    {0, 3}, {1, 3}, {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
    {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}, {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}};
__constant__ int kCircle4[kR4][2] = {
    {0, 4}, {1, 4}, {2, 3}, {3, 2}, {4, 1}, {4, 0}, {4, -1}, {3, -2}, {2, -3},
    {1, -4}, {0, -4}, {-1, -4}, {-2, -3}, {-3, -2}, {-4, -1}, {-4, 0}, {-4, 1},
    {-3, 2}, {-2, 3}, {-1, 4}};

template <bool kTranspose, int S3LO, int S3HI, int S4LO, int S4HI>
__global__ void __launch_bounds__(kThreads)
efast_stencil_kernel(const int32_t* __restrict__ sae, int h, int w,
                     const uint8_t* __restrict__ active, int nwt, int band,
                     int wtile, int border, int sensor_w, int sensor_h,
                     int s3min, int s3max, int s4min, int s4max,
                     uint8_t* __restrict__ out) {
  extern __shared__ int32_t halo[];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int r0 = blockIdx.z * kRows;          // first tile row of this CTA
  const int x0 = tx * wtile, y0 = ty * band + r0;
  const int rows = min(kRows, min(band - r0, h - y0));
  const int cols = min(wtile, w - x0);
  if (rows <= 0) return;

  if (active[ty * nwt + tx] == 0) {
    if ((w & 15) == 0 && (wtile & 15) == 0 && cols == wtile) {
      const int per_row = wtile >> 4;
      for (int q = threadIdx.x; q < rows * per_row; q += blockDim.x) {
        uint8_t* dst = out + (size_t)(y0 + q / per_row) * w + x0 + 16 * (q % per_row);
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int q = threadIdx.x; q < rows * cols; q += blockDim.x)
        out[(size_t)(y0 + q / cols) * w + x0 + q % cols] = 0;
    }
    return;
  }

  const int hw = wtile + 2 * kHalo;
  const int hn = (rows + 2 * kHalo) * hw;
  for (int q = threadIdx.x; q < hn; q += blockDim.x) {
    const int gy = y0 + q / hw - kHalo, gx = x0 + q % hw - kHalo;
    halo[q] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? sae[(size_t)gy * w + gx] : 0;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < rows * cols; q += blockDim.x) {
    const int r = q / cols, c = q % cols;
    const int gy = y0 + r, gx = x0 + c;
    bool corner = gx >= border && gx < sensor_w - border && gy >= border &&
                  gy < sensor_h - border;
    const int32_t* centre = halo + (r + kHalo) * hw + (c + kHalo);
    if (corner) {
      int ring3[kR3];
#pragma unroll
      for (int k = 0; k < kR3; ++k)
        ring3[k] = centre[kCircle3[k][kTranspose ? 1 : 0] * hw +
                          kCircle3[k][kTranspose ? 0 : 1]];
      corner = streak_any<kR3, S3LO, S3HI>(ring3, s3min, s3max);
    }
    if (corner) {
      int ring4[kR4];
#pragma unroll
      for (int k = 0; k < kR4; ++k)
        ring4[k] = centre[kCircle4[k][kTranspose ? 1 : 0] * hw +
                          kCircle4[k][kTranspose ? 0 : 1]];
      corner = streak_any<kR4, S4LO, S4HI>(ring4, s4min, s4max);
    }
    out[(size_t)gy * w + gx] = corner ? 1 : 0;
  }
}

template <bool kTranspose, int S3LO, int S3HI, int S4LO, int S4HI>
cudaError_t launch(const int32_t* sae, int h, int w, const uint8_t* active,
                   int nb, int nwt, int band, int wtile, int border,
                   int sensor_w, int sensor_h, int s3min, int s3max, int s4min,
                   int s4max, uint8_t* out, cudaStream_t stream) {
  auto kernel = efast_stencil_kernel<kTranspose, S3LO, S3HI, S4LO, S4HI>;
  const size_t smem =
      sizeof(int32_t) * (size_t)(kRows + 2 * kHalo) * (size_t)(wtile + 2 * kHalo);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nwt, nb, (band + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(sae, h, w, active, nwt, band, wtile,
                                           border, sensor_w, sensor_h, s3min,
                                           s3max, s4min, s4max, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int efast_stencil(const void* sae, int h, int w, const void* active,
                             int nb, int nwt, int band, int wtile, int border,
                             int sensor_w, int sensor_h, int s3min, int s3max,
                             int s4min, int s4max, int transpose, void* out,
                             void* stream) {
  if (!efast::streaks_legal(s3min, s3max, s4min, s4max) || band < 1 || wtile < 1)
    return (int)cudaErrorInvalidValue;
  const bool dflt = s3min == 3 && s3max == 6 && s4min == 4 && s4max == 8;
#define EFAST_LAUNCH(T, A, B, C, D)                                             \
  return (int)launch<T, A, B, C, D>(                                           \
      static_cast<const int32_t*>(sae), h, w,                                  \
      static_cast<const uint8_t*>(active), nb, nwt, band, wtile, border,       \
      sensor_w, sensor_h, s3min, s3max, s4min, s4max,                          \
      static_cast<uint8_t*>(out), (cudaStream_t)stream)
  if (dflt && transpose) EFAST_LAUNCH(true, 3, 6, 4, 8);
  if (dflt) EFAST_LAUNCH(false, 3, 6, 4, 8);
  if (transpose) EFAST_LAUNCH(true, 1, kR3 - 1, 1, kR4 - 1);
  EFAST_LAUNCH(false, 1, kR3 - 1, 1, kR4 - 1);
#undef EFAST_LAUNCH
}
