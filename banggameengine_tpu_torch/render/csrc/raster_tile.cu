// Full-carry tile raster: per listed 32x128-pixel tile, the nearest binned
// sub-triangle at every pixel with its depth, original triangle id,
// original-space barycentrics and slot, for Hopper.
//
// Replaces the TPU kernel `_tile_kernel` of
// banggameengine_tpu/render/raster_pallas.py (entry `raster_tiles_pallas`).
// Same contract, written for the GPU:
//
//   tile_idx [n] i32, the screen tile of each listed tile (the heavy pass
//     lists a subset of the screen's tiles)
//   x, y, z  [n, k, 3] f32, screen coordinates and NDC depth of each slot's
//     three corners
//   cb1, cb2 [n, k, 3] f32, the corners' barycentric coordinates 1 and 2
//     in the original (un-clipped) triangle
//   oid, ok  [n, k] i32, the original triangle id; ok != 0 marks a used slot
//   depth    [n, 4096] f32 out: winning NDC depth, 1.0 where none
//   tri      [n, 4096] i32 out: winning original triangle id, -1 where none
//   b1, b2   [n, 4096] f32 out: its original-space barycentrics, 0 where none
//   slot     [n, 4096] i32 out: winning slot, -1 where none
//
// Pixel p of listed tile i sits where pixel p of screen tile tile_idx[i]
// does; coverage, depth and the walk order are tile_walk.cuh's, over all k
// slots (the TPU kernel's select chain, and the first-minimum argmin of the
// XLA scan).  The winner's barycentrics are w0*c0 + w1*c1 + w2*c2 of its
// corners' cb1 / cb2.
//
// Bit-equality with the plain PyTorch version needs the same f32 rounding
// at every step: build with --fmad=false (no fused multiply-adds), never
// with fast math, and keep the expressions in the plain version's order.
//
// Design: one block of 256 threads per listed tile; thread i owns the 16
// pixels i, i + 256, ..., all in one column, so the five carried values of
// each pixel stay in registers (80 of them).  The tile's slots are staged
// through shared memory 64 at a time and read by every thread as
// broadcasts; a slot with ok == 0 is skipped by the whole block.  What
// bounds it: ~33 f32 operations per (pixel, used slot); the 1080p light
// pass (510 tiles x 64 slots) is at most 134 M pixel-slot pairs, ~4.4 G
// operations, well under a millisecond of the card's f32 rate.  The
// winner's barycentrics cost 10 operations more, once per update.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using tile_walk::kPerThread;
using tile_walk::kStage;
using tile_walk::kThreads;
using tile_walk::kTileH;
using tile_walk::kTilePx;
using tile_walk::kTileW;
// staged row: x0..2, y0..2, z0..2 (tile_walk::setup's), cb1_0..2, cb2_0..2
constexpr int kCarryCh = 15;

__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const int* __restrict__ tile_idx,
                   const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, const int* __restrict__ oid,
                   const float* __restrict__ cb1,
                   const float* __restrict__ cb2, const int* __restrict__ ok,
                   int k, int tiles_x, float* __restrict__ depth_out,
                   int* __restrict__ tri_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out, int* __restrict__ slot_out) {
  __shared__ float rows[kStage][kCarryCh];
  __shared__ int oids[kStage];
  __shared__ int oks[kStage];
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile = tile_idx[item];
  const float px =
      static_cast<float>((tile % tiles_x) * kTileW + tid % kTileW) + 0.5f;
  const int y_base = (tile / tiles_x) * kTileH + tid / kTileW;
  constexpr int kRowStep = kThreads / kTileW;    // 2 rows between pixels

  float zbuf[kPerThread];
  int tri[kPerThread];
  float b1[kPerThread];
  float b2[kPerThread];
  int best[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    zbuf[i] = INFINITY;
    tri[i] = -1;
    b1[i] = 0.0f;
    b2[i] = 0.0f;
    best[i] = -1;
  }

  const long long row0 = static_cast<long long>(item) * k;
  for (int base = 0; base < k; base += kStage) {
    const int n = min(kStage, k - base);
    __syncthreads();                  // the previous stage is consumed
    for (int e = tid; e < 3 * n; e += kThreads) {
      const int s = e / 3;
      const int j = e - 3 * s;
      const long long src = (row0 + base) * 3 + e;
      rows[s][j] = x[src];
      rows[s][3 + j] = y[src];
      rows[s][6 + j] = z[src];
      rows[s][9 + j] = cb1[src];
      rows[s][12 + j] = cb2[src];
    }
    for (int s = tid; s < n; s += kThreads) {
      oids[s] = oid[row0 + base + s];
      oks[s] = ok[row0 + base + s];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      if (oks[s] == 0) continue;                 // same for every thread
      const tile_walk::Tri t = tile_walk::setup(rows[s]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float py = static_cast<float>(y_base + kRowStep * i) + 0.5f;
        float w0, w1, w2, d;
        if (tile_walk::covers(t, px, py, w0, w1, w2, d) & (d < zbuf[i])) {
          zbuf[i] = d;
          tri[i] = oids[s];
          b1[i] = w0 * rows[s][9] + w1 * rows[s][10] + w2 * rows[s][11];
          b2[i] = w0 * rows[s][12] + w1 * rows[s][13] + w2 * rows[s][14];
          best[i] = base + s;
        }
      }
    }
  }

  const long long out0 = static_cast<long long>(item) * kTilePx;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long o = out0 + tid + kThreads * i;
    depth_out[o] = isfinite(zbuf[i]) ? zbuf[i] : 1.0f;
    tri_out[o] = tri[i];
    b1_out[o] = b1[i];
    b2_out[o] = b2[i];
    slot_out[o] = best[i];
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated.
extern "C" int raster_tile_launch(const int* tile_idx, const float* x,
                                  const float* y, const float* z,
                                  const int* oid, const float* cb1,
                                  const float* cb2, const int* ok, int n,
                                  int k, int tiles_x, float* depth, int* tri,
                                  float* b1, float* b2, int* slot,
                                  void* stream) {
  if (n < 1 || k < 0 || tiles_x < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  raster_tile_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_idx, x, y, z, oid, cb1, cb2, ok, k, tiles_x, depth, tri, b1, b2,
      slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
