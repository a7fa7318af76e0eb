// Per-tile attribute resolve: each pixel's winning slot selects a column of
// its tile's attribute table, written channel-planar, for Hopper.
//
// Replaces the TPU kernel `_resolve_wide_kernel` of
// banggameengine_tpu/render/resolve_pallas.py (entry
// `resolve_tiles_pallas_wide`).  The TPU does this as a one-hot matrix
// product on its matrix unit, skipping chunks of the one-hot past each
// tile's largest slot.  On the GPU it is a plain gather:
//
//   out[c][t][p] = (0 <= slot[t][p] < kl) ? table[t][c][slot[t][p]] : 0
//
//   slot  [n_tiles, px] i32 (-1 = background)
//   table [n_tiles, c, kl] f32
//   out   [c, n_tiles, px] f32, each channel plane contiguous
//
// The one-hot product has exactly one non-zero term per covered pixel, so
// for finite tables the gather gives the same numbers (a -0.0 entry comes
// back as -0.0 here and as +0.0 from the product; they compare equal).
//
// Design: one thread per (tile, pixel) walks the c channels; consecutive
// threads write consecutive addresses of each plane.  What bounds it: the
// writes, 4 c bytes per pixel (40 channels x 2.1 M pixels = 334 MB at
// 1080p, ~0.1 ms of the card's memory bandwidth); the table reads hit the
// tile's 43 KB table in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resolve_wide_kernel(const int* __restrict__ slot,
                    const float* __restrict__ table, long long n_pix, int px,
                    int c, int kl, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_pix) return;
  const long long t = i / px;
  const int s = slot[i];
  const bool valid = (s >= 0) & (s < kl);
  const float* tab = table + t * c * kl + (valid ? s : 0);
  for (int ch = 0; ch < c; ++ch) {
    out[ch * n_pix + i] = valid ? tab[static_cast<long long>(ch) * kl] : 0.0f;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated.
extern "C" int resolve_wide_launch(const int* slot, const float* table,
                                   int n_tiles, int px, int c, int kl,
                                   float* out, void* stream) {
  if (n_tiles < 1 || px < 1 || c < 1 || kl < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_pix = static_cast<long long>(n_tiles) * px;
  const unsigned blocks =
      static_cast<unsigned>((n_pix + kThreads - 1) / kThreads);
  resolve_wide_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      slot, table, n_pix, px, c, kl, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resolve_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
