// The per-tile visibility walk that raster_walk.cu and raster_resolve.cu
// share, and the coverage test of one binned slot at one pixel that
// raster_tile.cu shares too: one block of 256 threads walks one 32x128-pixel
// tile.
//
//   pack   [k_pad, 16] f32, the tile's rows, one per binned slot:
//     x0 x1 x2 y0 y1 y2 (screen coords) z0 z1 z2 (NDC depth) ok (> 0 = used)
//   walked slots 0 .. walked-1 are walked (the rest is padding)
//
// Pixel p of tile t sits at x = (t % tiles_x) * 128 + p % 128 + 0.5,
// y = (t / tiles_x) * 32 + p / 128 + 0.5.  A slot covers a pixel when the
// three edge functions agree in sign with the triangle's area (two-sided),
// and its barycentric depth w0*z0 + w1*z1 + w2*z2 lies in [0, 1].
//
// Order: every pixel walks its slots in order and takes a slot only when it
// is strictly nearer than the best so far.  The winner is the lowest slot
// that reaches the minimum depth, which is what the TPU kernels' rule
// (first minimum within a chunk of 8, strictly nearer across chunks) picks
// too.
//
// Bit-equality with the plain PyTorch version needs the same f32 rounding
// at every step: build with --fmad=false (no fused multiply-adds), never
// with fast math, and keep the expressions in the plain version's order.
//
// Thread i owns the 16 pixels i, i + 256, ..., all in one column, so its x
// is fixed and its depth and slot stay in registers.  The tile's rows are
// staged through shared memory 64 slots at a time and read by every thread
// as broadcasts; a row with ok == 0 is skipped by the whole block.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tile_walk {

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kThreads = 256;
constexpr int kPerThread = kTilePx / kThreads;   // 16 pixels, one column
constexpr int kPackCh = 16;
constexpr int kRowCh = 10;                       // x0..z2, ok
constexpr int kStage = 64;                       // slots staged at a time

// One staged slot, set up once for every pixel of the tile: its corners,
// the sign of its area and the area's inverse.
struct Tri {
  float x0, x1, x2, y0, y1, y2, z0, z1, z2;
  bool apos;
  float inv_area;
};

// `r` holds x0 x1 x2 y0 y1 y2 z0 z1 z2.
__device__ __forceinline__ Tri setup(const float* r) {
  Tri t{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], false, 0.0f};
  const float area =
      (t.x1 - t.x0) * (t.y2 - t.y0) - (t.y1 - t.y0) * (t.x2 - t.x0);
  t.apos = area > 0.0f;
  t.inv_area = 1.0f / (fabsf(area) > 1e-9f ? area : 1e-9f);
  return t;
}

// Whether the slot covers pixel (px, py) at a depth in [0, 1]; leaves the
// barycentric weights and the depth in w0, w1, w2 and d either way.
__device__ __forceinline__ bool covers(const Tri& t, float px, float py,
                                       float& w0, float& w1, float& w2,
                                       float& d) {
  const float e0 = (t.x1 - t.x0) * (py - t.y0) - (t.y1 - t.y0) * (px - t.x0);
  const float e1 = (t.x2 - t.x1) * (py - t.y1) - (t.y2 - t.y1) * (px - t.x1);
  const float e2 = (t.x0 - t.x2) * (py - t.y2) - (t.y0 - t.y2) * (px - t.x2);
  const bool pos = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f);
  const bool neg = (e0 <= 0.0f) & (e1 <= 0.0f) & (e2 <= 0.0f);
  w1 = e2 * t.inv_area;
  w2 = e0 * t.inv_area;
  w0 = 1.0f - w1 - w2;
  d = w0 * t.z0 + w1 * t.z1 + w2 * t.z2;
  return (t.apos ? pos : neg) & (d >= 0.0f) & (d <= 1.0f);
}

// Walks `walked` rows of `pack` for tile `tile`; leaves each pixel's best
// depth (INFINITY where none) in zbuf and its slot (-1 where none) in best.
// `rows` is the block's shared staging buffer.  Every thread of the block
// must call it.
__device__ __forceinline__ void walk(const float* __restrict__ pack,
                                     int walked, int tile, int tiles_x,
                                     float (*rows)[kRowCh],
                                     float (&zbuf)[kPerThread],
                                     int (&best)[kPerThread]) {
  const int tid = threadIdx.x;
  const float px =
      static_cast<float>((tile % tiles_x) * kTileW + tid % kTileW) + 0.5f;
  const int y_base = (tile / tiles_x) * kTileH + tid / kTileW;
  constexpr int kRowStep = kThreads / kTileW;    // 2 rows between pixels

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    zbuf[i] = INFINITY;
    best[i] = -1;
  }
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
      const Tri tri = setup(rows[s]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float py = static_cast<float>(y_base + kRowStep * i) + 0.5f;
        float w0, w1, w2, d;
        if (covers(tri, px, py, w0, w1, w2, d) & (d < zbuf[i])) {
          zbuf[i] = d;
          best[i] = base + s;
        }
      }
    }
  }
}

}  // namespace tile_walk
