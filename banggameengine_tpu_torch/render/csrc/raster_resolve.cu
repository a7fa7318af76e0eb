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
// The walk is raster_walk.cu's, bit for bit (tile_walk.cuh); the resolve
// is resolve_wide.cu's gather.  The TPU kernel resolves with a one-hot
// product on its matrix unit, which gives the same numbers for finite
// tables (a -0.0 entry comes back as -0.0 here and +0.0 there; they compare
// equal).  Its padding of kl to 384 and c to a multiple of 8, and its
// skipping of 128-wide chunks past the tile's count, change no result and
// are not carried over.
//
// Design: one block of 256 threads per tile, 16 pixels per thread in
// registers (tile_walk.cuh).  After the walk the block stages the columns
// of its table that a winner can name (slots below the walked count) in
// dynamic shared memory, c x min(kl, walked) floats (43.5 KB at c = 40,
// kl = 272), and each thread writes its pixels' c values; consecutive
// threads write consecutive pixels of each channel plane.  The depth and
// slot never leave registers between the walk and the resolve.  What bounds
// it: the channel writes, 4 c bytes per pixel (334 MB at 1080p, ~0.1 ms of
// the card's memory bandwidth), then the walk's ~33 f32 operations per
// (pixel, used slot).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using namespace tile_walk;

__global__ void __launch_bounds__(kThreads)
raster_resolve_kernel(const int* __restrict__ counts,
                      const float* __restrict__ tri_pack, int k_pad,
                      int tiles_x, const float* __restrict__ table, int c,
                      int kl, float* __restrict__ depth_out,
                      int* __restrict__ slot_out, float* __restrict__ out) {
  __shared__ float rows[kStage][kRowCh];
  extern __shared__ float tab[];      // [c][kl_used]
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int walked = min(max(counts[tile], 0), k_pad);
  float zbuf[kPerThread];
  int best[kPerThread];
  walk(tri_pack + static_cast<long long>(tile) * k_pad * kPackCh, walked,
       tile, tiles_x, rows, zbuf, best);

  const long long out0 = static_cast<long long>(tile) * kTilePx;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = tid + kThreads * i;
    depth_out[out0 + p] = isfinite(zbuf[i]) ? zbuf[i] : 1.0f;
    slot_out[out0 + p] = best[i];
  }
  if (c == 0) return;                 // depth and slot only

  // every winner lies below `walked`, so only those columns are needed
  const int kl_used = min(kl, walked);
  const float* src = table + static_cast<long long>(tile) * c * kl;
  for (int e = tid; e < c * kl_used; e += kThreads) {
    const int ch = e / kl_used;
    const int s = e - ch * kl_used;
    tab[e] = src[ch * kl + s];
  }
  __syncthreads();
  const long long n_pix = static_cast<long long>(gridDim.x) * kTilePx;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = best[i];
    const bool valid = (s >= 0) & (s < kl_used);
    const long long o = out0 + tid + kThreads * i;
    if (valid) {
      for (int ch = 0; ch < c; ++ch) {
        out[ch * n_pix + o] = tab[ch * kl_used + s];
      }
    } else {
      for (int ch = 0; ch < c; ++ch) out[ch * n_pix + o] = 0.0f;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated;
// `table` and `out` may be null when c == 0.  The table's staged columns
// take c * min(kl, k_pad) floats of dynamic shared memory, at most
// 227 KB less the walk's 2.5 KB of rows.
extern "C" int raster_resolve_launch(const int* counts, const float* tri_pack,
                                     int n_tiles, int k_pad, int tiles_x,
                                     const float* table, int c, int kl,
                                     float* depth, int* slot, float* out,
                                     void* stream) {
  if (n_tiles < 1 || k_pad < 0 || tiles_x < 1 || c < 0 ||
      (c > 0 && kl < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = kl < k_pad ? kl : k_pad;
  const size_t smem = static_cast<size_t>(c) * cols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_resolve_kernel<<<n_tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      counts, tri_pack, k_pad, tiles_x, table, c, kl, depth, slot, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_resolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
