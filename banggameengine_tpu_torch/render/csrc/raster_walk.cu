// Tiled visibility walk: per 32x128-pixel tile, the nearest binned
// sub-triangle and its depth at every pixel, for Hopper.
//
// Replaces the TPU kernel `_walk_kernel` of
// banggameengine_tpu/render/raster_resolve_pallas.py (entry
// `raster_walk_pallas`).  Same contract, written for the GPU:
//
//   tri_pack [n_tiles, k_pad, 16] f32, one row per binned slot of the tile:
//     x0 x1 x2 y0 y1 y2 (screen coords) z0 z1 z2 (NDC depth) ok (> 0 = used)
//   counts   [n_tiles] i32, slots of the tile to walk (the rest is padding)
//   depth    [n_tiles, 4096] f32 out: winning NDC depth, 1.0 where none
//   slot     [n_tiles, 4096] i32 out: winning slot, -1 where none
//
// Pixel p of tile t sits at x = (t % tiles_x) * 128 + p % 128 + 0.5,
// y = (t / tiles_x) * 32 + p / 128 + 0.5.  A slot covers a pixel when the
// three edge functions agree in sign with the triangle's area (two-sided),
// and its barycentric depth w0*z0 + w1*z1 + w2*z2 lies in [0, 1].
//
// Order: every pixel walks slots 0 .. count-1 in order and takes a slot
// only when it is strictly nearer than the best so far.  The winner is
// the lowest slot that reaches the minimum depth, which is what the TPU
// kernel's rule (first minimum within a chunk of 8, strictly nearer across
// chunks) picks too.
//
// Bit-equality with the plain PyTorch version needs the same f32 rounding
// at every step: build with --fmad=false (no fused multiply-adds), never
// with fast math, and keep the expressions in the plain version's order.
//
// Design: one block of 256 threads per tile; thread i owns the 16 pixels
// i, i + 256, ..., all in one column, so its x is fixed and its depth and
// slot stay in registers.  The tile's rows are staged through shared
// memory 64 slots at a time and read by every thread as broadcasts.  What
// bounds it: ~25 f32 operations per (pixel, slot); a 1080p frame of 510
// tiles with ~30 slots each is ~1.6 G operations, a fraction of a
// millisecond of the card's f32 rate.  Dense tiles (up to 272 slots) take
// proportionally longer; one block per tile lets the light tiles finish
// and free their SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kThreads = 256;
constexpr int kPerThread = kTilePx / kThreads;   // 16 pixels, one column
constexpr int kPackCh = 16;
constexpr int kRowCh = 10;                       // x0..z2, ok
constexpr int kStage = 64;                       // slots staged at a time

__global__ void __launch_bounds__(kThreads)
raster_walk_kernel(const int* __restrict__ counts,
                   const float* __restrict__ tri_pack, int k_pad,
                   int tiles_x, float* __restrict__ depth_out,
                   int* __restrict__ slot_out) {
  __shared__ float rows[kStage][kRowCh];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px =
      static_cast<float>((tile % tiles_x) * kTileW + tid % kTileW) + 0.5f;
  const int y_base = (tile / tiles_x) * kTileH + tid / kTileW;
  constexpr int kRowStep = kThreads / kTileW;    // 2 rows between pixels

  float zbuf[kPerThread];
  int best[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    zbuf[i] = INFINITY;
    best[i] = -1;
  }

  const int walked = min(max(counts[tile], 0), k_pad);
  const float* pack =
      tri_pack + static_cast<long long>(tile) * k_pad * kPackCh;
  for (int base = 0; base < walked; base += kStage) {
    const int n = min(kStage, walked - base);
    __syncthreads();                  // the previous stage is consumed
    for (int e = tid; e < n * kRowCh; e += kThreads) {
      const int s = e / kRowCh;
      const int c = e - s * kRowCh;
      rows[s][c] = pack[(base + s) * kPackCh + c];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      if (!(rows[s][9] > 0.0f)) continue;        // same for every thread
      const float x0 = rows[s][0], x1 = rows[s][1], x2 = rows[s][2];
      const float y0 = rows[s][3], y1 = rows[s][4], y2 = rows[s][5];
      const float z0 = rows[s][6], z1 = rows[s][7], z2 = rows[s][8];
      const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
      const bool apos = area > 0.0f;
      const float inv_area = 1.0f / (fabsf(area) > 1e-9f ? area : 1e-9f);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float py = static_cast<float>(y_base + kRowStep * i) + 0.5f;
        const float e0 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
        const float e1 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
        const float e2 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2);
        const bool pos = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f);
        const bool neg = (e0 <= 0.0f) & (e1 <= 0.0f) & (e2 <= 0.0f);
        const bool cover = apos ? pos : neg;
        const float w1 = e2 * inv_area;
        const float w2 = e0 * inv_area;
        const float w0 = 1.0f - w1 - w2;
        const float d = w0 * z0 + w1 * z1 + w2 * z2;
        if (cover & (d >= 0.0f) & (d <= 1.0f) & (d < zbuf[i])) {
          zbuf[i] = d;
          best[i] = base + s;
        }
      }
    }
  }

  const long long out0 = static_cast<long long>(tile) * kTilePx;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = tid + kThreads * i;
    depth_out[out0 + p] = isfinite(zbuf[i]) ? zbuf[i] : 1.0f;
    slot_out[out0 + p] = best[i];
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated.
extern "C" int raster_walk_launch(const int* counts, const float* tri_pack,
                                  int n_tiles, int k_pad, int tiles_x,
                                  float* depth, int* slot, void* stream) {
  if (n_tiles < 1 || k_pad < 0 || tiles_x < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  raster_walk_kernel<<<n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      counts, tri_pack, k_pad, tiles_x, depth, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
