// Fused visibility walk + attribute resolve: per 32x128-pixel tile, the
// nearest binned sub-triangle at every pixel, then the winner's column of
// the tile's attribute table, written channel-planar, for Hopper.
//
// Replaces the TPU kernel `_raster_resolve_kernel` of
// banggameengine_tpu/render/raster_resolve_pallas.py (entry
// `raster_resolve_tiles_pallas`).  Same contract, written for the GPU:
//
//   counts   [n_tiles] i32, slots of the tile to walk (the rest is padding)
//   tri_pack [n_tiles, k_pad, 16] f32, one row per binned slot of the tile
//     (layout, coverage and tie rule in tile_walk.cuh)
//   table    [n_tiles, c, kl] f32, the tile's attribute table, or null
//     (c = 0) for depth and slot only
//   depth    [n_tiles, 4096] f32 out: winning NDC depth, 1.0 where none
//   slot     [n_tiles, 4096] i32 out: winning slot, -1 where none
//   out      [c, n_tiles, 4096] f32 out:
//              (0 <= slot < kl) ? table[t][ch][slot] : 0
//
// The walk is raster_walk.cu's, bit for bit (tile_walk::band_walk over the
// same packed rows); the resolve is resolve_wide.cu's gather.  The TPU
// kernel resolves with a one-hot product on its matrix unit, which gives
// the same numbers for finite tables (a -0.0 entry comes back as -0.0 here
// and +0.0 there; they compare equal; an inf or NaN entry there spreads
// over its tile's channel, here it reaches only the pixels that select
// it).  Its padding of kl to 384 and c to a multiple of 8, and its skipping
// of 128-wide chunks past the tile's count, change no result and are not
// carried over.
//
// What bounds it: the channel writes, 4 c bytes per pixel (334 MB at
// 1080p and c = 40, ~0.1 ms of the card's memory bandwidth), then the
// walk's ~33 f32 operations per (pixel, used slot).  Design: n_tiles x
// kBands blocks of 128 threads, each the banded walk of 4 pixel rows of
// one tile (tile_walk.cuh), so the dense tiles' walks spread over the SMs
// while the other blocks write.  After its walk a block writes its 4 x 128
// pixels of each channel plane straight from registers, 512 consecutive
// floats a channel, and each thread reads its pixels' table entries with
// __ldg from the tile's table (<= 43.5 KB at c = 40, kl = 272), which the
// tile's 8 band blocks share through L1 and L2, as resolve_wide.cu does;
// no shared memory is staged for it, so the table's width does not limit
// how many blocks an SM holds.  The planes go out as streaming stores
// (__stcs: written once, read by a later kernel), which took 0.139 ms
// against 0.148 for plain stores on the 10k-box view at 1080p and the same
// 0.133 on the showcase (NVIDIA H100 80GB HBM3, 700 W, one run).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using namespace tile_walk;

__global__ void __launch_bounds__(kBandThreads)
raster_resolve_kernel(const int* __restrict__ counts,
                      const float* __restrict__ tri_pack, int k_pad,
                      int tiles_x, const float* __restrict__ table, int c,
                      int kl, float* __restrict__ depth_out,
                      int* __restrict__ slot_out, float* __restrict__ out) {
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
  if (c == 0) return;                 // depth and slot only

  const long long n_pix =
      static_cast<long long>(gridDim.x / kBands) * kTilePx;
  const float* tab = table + static_cast<long long>(tile) * c * kl;
  bool valid[kRows];
  int col[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    valid[i] = (best[i] >= 0) & (best[i] < kl);
    col[i] = valid[i] ? best[i] : 0;
  }
#pragma unroll 4
  for (int ch = 0; ch < c; ++ch) {
    const float* src = tab + static_cast<long long>(ch) * kl;
    float* dst = out + ch * n_pix + out0;
    float v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      v[i] = valid[i] ? __ldg(src + col[i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) __stcs(dst + i * kTileW, v[i]);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated;
// `table` and `out` may be null when c == 0.
extern "C" int raster_resolve_launch(const int* counts, const float* tri_pack,
                                     int n_tiles, int k_pad, int tiles_x,
                                     const float* table, int c, int kl,
                                     float* depth, int* slot, float* out,
                                     void* stream) {
  if (n_tiles < 1 || k_pad < 0 || tiles_x < 1 || c < 0 ||
      (c > 0 && kl < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(n_tiles) * kBands;
  raster_resolve_kernel<<<blocks, kBandThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      counts, tri_pack, k_pad, tiles_x, table, c, kl, depth, slot, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_resolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
