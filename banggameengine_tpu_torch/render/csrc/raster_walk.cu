// Tiled visibility walk: per 32x128-pixel tile, the nearest binned
// sub-triangle and its depth at every pixel, for Hopper.
//
// Replaces the TPU kernel `_walk_kernel` of
// banggameengine_tpu/render/raster_resolve_pallas.py (entry
// `raster_walk_pallas`).  Same contract, written for the GPU:
//
//   tri_pack [n_tiles, k_pad, 16] f32, one row per binned slot of the tile
//     (layout, coverage and tie rule in tile_walk.cuh)
//   counts   [n_tiles] i32, slots of the tile to walk (the rest is padding)
//   depth    [n_tiles, 4096] f32 out: winning NDC depth, 1.0 where none
//   slot     [n_tiles, 4096] i32 out: winning slot, -1 where none
//
// What bounds it: ~33 f32 operations per (pixel, used slot), ~1.7 G for a
// 1080p showcase frame, 0.025 ms of the card's f32 rate.  The kernel is
// tile_walk::band_walk over the packed rows: n_tiles x kBands blocks of
// 128 threads, each a band of 4 pixel rows of one tile, whose warps skip
// the slots whose cover boxes miss their 32 x 4 pixels (design and proof
// in tile_walk.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using namespace tile_walk;

__global__ void __launch_bounds__(kBandThreads)
raster_walk_kernel(const int* __restrict__ counts,
                   const float* __restrict__ tri_pack, int k_pad,
                   int tiles_x, float* __restrict__ depth_out,
                   int* __restrict__ slot_out) {
  const int tile = blockIdx.x / kBands;
  const int band = blockIdx.x - tile * kBands;
  const int walked = min(max(counts[tile], 0), k_pad);
  float zbuf[kRows];
  int best[kRows];
  band_walk(PackRows{tri_pack + static_cast<long long>(tile) * k_pad *
                                    kPackCh},
            walked, (tile % tiles_x) * kTileW,
            (tile / tiles_x) * kTileH + band * kRows, zbuf, best);

  const long long out0 = static_cast<long long>(tile) * kTilePx +
                         band * kRows * kTileW + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    depth_out[out0 + i * kTileW] = isfinite(zbuf[i]) ? zbuf[i] : 1.0f;
    slot_out[out0 + i * kTileW] = best[i];
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
  const unsigned blocks = static_cast<unsigned>(n_tiles) * kBands;
  raster_walk_kernel<<<blocks, kBandThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      counts, tri_pack, k_pad, tiles_x, depth, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
