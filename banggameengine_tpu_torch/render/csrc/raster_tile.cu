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
// What bounds it: ~33 f32 operations per (pixel, used slot).  The heavy
// pass lists the 64 tiles with the most locals (up to 272 slots each), the
// light pass every tile at up to 64 slots.  Design: tile_walk::band_walk
// over the listed tile's x, y, z and ok arrays, n x kBands blocks of 128
// threads in both passes, so a heavy pass of 64 dense tiles fills the
// card with 512 blocks; each warp skips the slots whose cover boxes miss
// its 32 x 4 pixels (an unused slot has an empty box).  Only depth and
// slot are carried through the walk.  After it each covered pixel sets its
// winner up again from the winner's row (read through L2) and recomputes
// the weights with tile_walk::covers, which are those its winning test
// computed, bit for bit (the same row at the same pixel, no fused
// multiply-adds), then writes the winner's id and barycentrics.  That
// keeps 8 registers of carry a thread instead of 20 and costs ~50
// operations a covered pixel, once.  It measured faster than staging oid,
// cb1 and cb2 beside the slots and updating them at every win: light +
// heavy 0.097 against 0.108 ms on the showcase at 1080p, 0.082 against
// 0.089 on the 10k-box view (NVIDIA H100 80GB HBM3, 700 W, one run).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using namespace tile_walk;

// The rows of one listed tile: x, y, z [k, 3] and ok [k] from its first
// slot on; slot s is used when ok[s] != 0.
struct CarryRows {
  const float* x;
  const float* y;
  const float* z;
  const int* ok;

  // Whether slot s is used; if it is, its corners go to r.
  __device__ __forceinline__ bool load(int s, float (&r)[kCorners]) const {
    if (__ldg(ok + s) == 0) return false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[j] = __ldg(x + 3 * s + j);
      r[3 + j] = __ldg(y + 3 * s + j);
      r[6 + j] = __ldg(z + 3 * s + j);
    }
    return true;
  }
};

__global__ void __launch_bounds__(kBandThreads)
raster_tile_kernel(const int* __restrict__ tile_idx,
                   const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, const int* __restrict__ oid,
                   const float* __restrict__ cb1,
                   const float* __restrict__ cb2, const int* __restrict__ ok,
                   int k, int tiles_x, float* __restrict__ depth_out,
                   int* __restrict__ tri_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out, int* __restrict__ slot_out) {
  const int item = blockIdx.x / kBands;
  const int band = blockIdx.x - item * kBands;
  const int tid = threadIdx.x;
  const int tile = tile_idx[item];
  const long long row0 = static_cast<long long>(item) * k;
  const CarryRows rows{x + row0 * 3, y + row0 * 3, z + row0 * 3, ok + row0};
  const int x_base = (tile % tiles_x) * kTileW;
  const int y_base = (tile / tiles_x) * kTileH + band * kRows;
  float zbuf[kRows];
  int best[kRows];
  band_walk(rows, k, x_base, y_base, zbuf, best);

  const float px = static_cast<float>(x_base + tid) + 0.5f;
  const long long out0 = static_cast<long long>(item) * kTilePx +
                         band * kRows * kTileW + tid;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = best[i];
    int tri = -1;
    float b1 = 0.0f;
    float b2 = 0.0f;
    if (s >= 0) {
      float r[kCorners];
      rows.load(s, r);                // a winner is a used slot
      const Tri t = setup(r);
      const float py = static_cast<float>(y_base + i) + 0.5f;
      float w0, w1, w2, d;
      covers(t, px, py, w0, w1, w2, d);
      const float* c1 = cb1 + (row0 + s) * 3;
      const float* c2 = cb2 + (row0 + s) * 3;
      tri = oid[row0 + s];
      b1 = w0 * c1[0] + w1 * c1[1] + w2 * c1[2];
      b2 = w0 * c2[0] + w1 * c2[1] + w2 * c2[2];
    }
    const long long o = out0 + i * kTileW;
    depth_out[o] = isfinite(zbuf[i]) ? zbuf[i] : 1.0f;
    tri_out[o] = tri;
    b1_out[o] = b1;
    b2_out[o] = b2;
    slot_out[o] = s;
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
  const unsigned blocks = static_cast<unsigned>(n) * kBands;
  raster_tile_kernel<<<blocks, kBandThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tile_idx, x, y, z, oid, cb1, cb2, ok, k, tiles_x, depth, tri, b1, b2,
      slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
