// eFAST corner mask over (band x wtile) tiles of the SAE time surface.
//
// Replaces evflow_tpu/ops/efast.py:corner_mask_dense_pallas_sparse2 (the
// tile-predicated Pallas stencil on the main path). With a band map
// broadcast over the tiles it also replaces corner_mask_dense_pallas_sparse,
// and with an all-ones map corner_mask_dense_pallas.
//
// One CTA per tile. An inactive tile writes zeros and exits. An active one
// stages its (band+8) x (wtile+8) int32 halo in shared memory (17 KB at
// 24 x 128), with zeros outside the image as jnp.pad gives, and each thread
// evaluates whole pixels: the 36 ring samples (circle3: 16, circle4: 20) are
// static offsets into the halo, and the streak test is the one of
// efast.py:_streak_any: some start i and arc length s in [smin, smax] with
//   ring[i] >= ring[i-1],  ring[i+s-1] >= ring[i+s],
//   min(ring[i .. i+s-1]) > max(ring[i+s .. i+R-1])   (indices mod R).
// Pixels within `border` of the sensor edge are False.
//
// What bounds it: integer compares. A pixel costs about 4 R^2 (~2.6k)
// min/max/compare operations for both rings, so a fully active 1280x720
// surface is ~2.4 G simple integer ops; the SAE read (3.7 MB) is minor.
// The design keeps that work off the idle tiles (early exit: slices touch
// few tiles), reads every SAE word once per tile from device memory
// (the halo), and walks each start i with a running arc minimum and a
// running off-arc maximum, so no (R, H, W) plane stack is ever stored.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 4;
constexpr int kR3 = 16;
constexpr int kR4 = 20;

// (dy, dx) in group_track order: time_surface.at(y + c[i][0], x + c[i][1])
__constant__ int kCircle3[kR3][2] = {
    {0, 3}, {1, 3}, {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
    {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}, {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}};
__constant__ int kCircle4[kR4][2] = {
    {0, 4}, {1, 4}, {2, 3}, {3, 2}, {4, 1}, {4, 0}, {4, -1}, {3, -2}, {2, -3},
    {1, -4}, {0, -4}, {-1, -4}, {-2, -3}, {-3, -2}, {-4, -1}, {-4, 0}, {-4, 1},
    {-3, 2}, {-2, 3}, {-1, 4}};

template <int R>
__device__ __forceinline__ bool streak_any(const int (&ring)[R], int smin,
                                           int smax) {
  bool found = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool c1 = ring[i] >= ring[(i + R - 1) % R];
    // amin[s] = min(ring[i .. i+s-1]) for s = 1 .. R-1
    int amin[R];
    int m = ring[i];
#pragma unroll
    for (int s = 1; s < R; ++s) {
      amin[s] = m;
      m = min(m, ring[(i + s) % R]);
    }
    // omax = max(ring[i+s .. i+R-1]), grown from the far end of the ring
    int omax = INT_MIN;
#pragma unroll
    for (int s = R - 1; s >= 1; --s) {
      omax = max(omax, ring[(i + s) % R]);
      const bool c2 = ring[(i + s - 1) % R] >= ring[(i + s) % R];
      found |= c1 & c2 & (s >= smin) & (s <= smax) & (omax < amin[s]);
    }
  }
  return found;
}

__global__ void __launch_bounds__(kThreads)
efast_stencil_kernel(const int32_t* __restrict__ sae, int h, int w,
                     const uint8_t* __restrict__ active, int nwt, int band,
                     int wtile, int border, int sensor_w, int sensor_h,
                     int s3min, int s3max, int s4min, int s4max,
                     int transpose, uint8_t* __restrict__ out) {
  extern __shared__ int32_t halo[];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int x0 = tx * wtile, y0 = ty * band;
  const int npix = band * wtile;

  if (active[ty * nwt + tx] == 0) {
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      const int gy = y0 + p / wtile, gx = x0 + p % wtile;
      if (gy < h && gx < w) out[(size_t)gy * w + gx] = 0;
    }
    return;
  }

  const int hw = wtile + 2 * kHalo;
  const int hn = (band + 2 * kHalo) * hw;
  for (int i = threadIdx.x; i < hn; i += blockDim.x) {
    const int gy = y0 + i / hw - kHalo, gx = x0 + i % hw - kHalo;
    halo[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? sae[(size_t)gy * w + gx] : 0;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int r = p / wtile, c = p % wtile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    bool corner = gx >= border && gx < sensor_w - border && gy >= border &&
                  gy < sensor_h - border;
    if (corner) {
      const int32_t* centre = halo + (r + kHalo) * hw + (c + kHalo);
      int ring3[kR3];
#pragma unroll
      for (int k = 0; k < kR3; ++k) {
        const int dy = transpose ? kCircle3[k][1] : kCircle3[k][0];
        const int dx = transpose ? kCircle3[k][0] : kCircle3[k][1];
        ring3[k] = centre[dy * hw + dx];
      }
      corner = streak_any<kR3>(ring3, s3min, s3max);
    }
    if (corner) {
      const int32_t* centre = halo + (r + kHalo) * hw + (c + kHalo);
      int ring4[kR4];
#pragma unroll
      for (int k = 0; k < kR4; ++k) {
        const int dy = transpose ? kCircle4[k][1] : kCircle4[k][0];
        const int dx = transpose ? kCircle4[k][0] : kCircle4[k][1];
        ring4[k] = centre[dy * hw + dx];
      }
      corner = streak_any<kR4>(ring4, s4min, s4max);
    }
    out[(size_t)gy * w + gx] = corner ? 1 : 0;
  }
}

}  // namespace

extern "C" int efast_stencil(const void* sae, int h, int w, const void* active,
                             int nb, int nwt, int band, int wtile, int border,
                             int sensor_w, int sensor_h, int s3min, int s3max,
                             int s4min, int s4max, int transpose, void* out,
                             void* stream) {
  const size_t smem =
      sizeof(int32_t) * (size_t)(band + 2 * kHalo) * (size_t)(wtile + 2 * kHalo);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        efast_stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nwt, nb);
  efast_stencil_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(sae), h, w,
      static_cast<const uint8_t*>(active), nwt, band, wtile, border, sensor_w,
      sensor_h, s3min, s3max, s4min, s4max, transpose,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
