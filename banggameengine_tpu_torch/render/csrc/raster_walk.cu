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
// 1080p showcase frame, 0.025 ms of the card's f32 rate.  The work is
// uneven: most tiles walk ~20-30 slots, the densest 246 (the showcase) or
// 272 (the 10k-box view).  One block per tile (tile_walk::walk, which the
// fused kernel keeps) would leave the densest tile's block to set the
// time, 8 warps on one SM while the other SMs sit idle.
//
// Design, for the densest tiles:
//   - Pixel bands.  A tile's 32 pixel rows are split over kTileH / kRows
//     blocks of 128 threads; thread x owns the kRows pixels of column x in
//     its band, in registers.  The grid is n_tiles x bands, tile by tile,
//     so a dense tile's bands start on different SMs side by side.  Of 1,
//     2, 4 and 8 rows a band, 4 was the fastest on both 1080p views.
//   - Set up once.  Every block stages its tile's rows 128 slots at a time;
//     each staging thread sets its slot up (tile_walk::setup: corners, the
//     sign of the area, the area's inverse) and computes its cover box
//     (below) once for every pixel of the band.
//   - Warp footprints.  A warp's pixels fill a 32 x kRows rectangle.  A
//     slot whose cover box misses the rectangle covers none of them, and
//     the warp skips it with four compares instead of 33 operations a
//     pixel.  An unused row (ok <= 0) gets an empty box.
//   Each pixel still walks the slots that can cover it in ascending order
//   and takes a slot only when strictly nearer, with tile_walk::covers, so
//   depth and slot are those of tile_walk::walk and of the plain version,
//   bit for bit (built with --fmad=false, as tile_walk.cuh requires).
//
// Why a slot cannot cover a pixel centre p outside its cover box.  Let u =
// 2^-24.  The corners are f32 values and p is exact (k + 0.5).  covers()
// computes each edge function e = fl(fl(dx * fl(py - y)) - fl(dy * fl(px -
// x))) with dx = fl(x' - x), dy = fl(y' - y): four roundings, so |e - E| <=
// 4.01u (|A| + |B|), where E = A - B is the exact edge function of the
// corners and A, B its two exact products (no product overflows for the
// corners allowed below; one that underflows adds at most 2^-149, which
// the pixel added to the margin below covers many times over).  Let S be
// the exact area (E0 + E1 + E2 = S at every point), W x H the corners'
// bounding box, R = max(W, H), P the sum of |dx| + |dy| over the three
// edges, and m the distance of p outside the box (max over x and y; 0
// inside).  Then |A| + |B| <= (|dx| + |dy|) (R + m), and the three errors
// sum to at most 4.01u P (R + m).  A slot is
// bounded when its corners are finite and within 1e7 of the origin, |S| >=
// 1e-6 and q = 2^-21 P R / |S| < 1/4 (computed in f64, whose rounding is
// far below these margins).  For a bounded slot:
//   - the computed area is within 4.01u P R < |S| / 8 of S, so it is not 0
//     and has the sign of S: covers() asks every e to have the sign of S
//     (or be 0), i.e. E_k sign(S) >= -err_k;
//   - the barycentric weights l_k = E_k / S are then >= -err_k / |S|, they
//     sum to 1, and px = sum l_k x_k, so xmin - px <= W sum err_k / |S| <=
//     q (R + m) / 2, the same for px - xmax and (with H) for y;
//   - so a covered p has m <= q (R + m) / 2, m <= q R / (2 - q) < 2 q R + 1.
// The cover box is the bounding box grown by 2 q R + 1 pixels, rounded
// outward to f32.  Any other slot (NaN or infinite corners, zero or tiny
// area, slivers with q >= 1/4) gets the whole plane and is never skipped:
// a zero-area row covers pixels on its line outside its bounding box.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

using namespace tile_walk;

constexpr int kBandThreads = kTileW;       // one thread per pixel column
constexpr int kBandStage = kBandThreads;   // slots set up at a time
constexpr int kWarp = 32;
constexpr int kRows = 4;                   // pixel rows per band (block)
constexpr int kBands = kTileH / kRows;
constexpr double kCoverErr = 0x1p-21;      // 8u: twice the edge error's 4u
constexpr double kCoverMaxCoord = 1e7;     // pixels, for a bounded slot
constexpr double kCoverMinArea = 1e-6;     // square pixels, the same

// One slot, set up for the walk (tile_walk::Tri).
struct alignas(16) Staged {
  float x0, x1, x2, y0, y1, y2, z0, z1, z2, inv_area, apos, pad;
};

// The region outside which the slot with corners r[0..5] (x0 x1 x2 y0 y1
// y2) covers no pixel centre, as (x lo, x hi, y lo, y hi): the header's
// bound, or the whole plane where it does not hold.
__device__ __forceinline__ float4 cover_box(const float* r) {
  const double x0 = r[0], x1 = r[1], x2 = r[2];
  const double y0 = r[3], y1 = r[4], y2 = r[5];
  const double xmin = fmin(fmin(x0, x1), x2), xmax = fmax(fmax(x0, x1), x2);
  const double ymin = fmin(fmin(y0, y1), y2), ymax = fmax(fmax(y0, y1), y2);
  const double area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
  const double p = fabs(x1 - x0) + fabs(y1 - y0) + fabs(x2 - x1) +
                   fabs(y2 - y1) + fabs(x0 - x2) + fabs(y0 - y2);
  const double w = fmax(xmax - xmin, ymax - ymin);
  const double q = kCoverErr * p * w / fabs(area);
  // every corner enters `area`, so a NaN corner fails each test here
  const bool bounded =
      fmax(fmax(-xmin, xmax), fmax(-ymin, ymax)) <= kCoverMaxCoord &&
      fabs(area) >= kCoverMinArea && q < 0.25;
  if (!bounded) return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const double m = 2.0 * q * w + 1.0;
  return make_float4(__double2float_rd(xmin - m), __double2float_ru(xmax + m),
                     __double2float_rd(ymin - m), __double2float_ru(ymax + m));
}

__global__ void __launch_bounds__(kBandThreads)
raster_walk_kernel(const int* __restrict__ counts,
                   const float* __restrict__ tri_pack, int k_pad,
                   int tiles_x, float* __restrict__ depth_out,
                   int* __restrict__ slot_out) {
  __shared__ float4 boxes[kBandStage];
  __shared__ Staged staged[kBandStage];
  const int tile = blockIdx.x / kBands;
  const int band = blockIdx.x - tile * kBands;
  const int tid = threadIdx.x;
  const float* pack =
      tri_pack + static_cast<long long>(tile) * k_pad * kPackCh;
  const int walked = min(max(counts[tile], 0), k_pad);
  const int x_base = (tile % tiles_x) * kTileW;
  const int y_base = (tile / tiles_x) * kTileH + band * kRows;
  const float px = static_cast<float>(x_base + tid) + 0.5f;
  // the warp's footprint: pixel centres wx0..wx1 x wy0..wy1
  const float wx0 =
      static_cast<float>(x_base + (tid & ~(kWarp - 1))) + 0.5f;
  const float wx1 = wx0 + static_cast<float>(kWarp - 1);
  const float wy0 = static_cast<float>(y_base) + 0.5f;
  const float wy1 = wy0 + static_cast<float>(kRows - 1);

  float zbuf[kRows];
  int best[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    zbuf[i] = INFINITY;
    best[i] = -1;
  }
  for (int base = 0; base < walked; base += kBandStage) {
    const int n = min(kBandStage, walked - base);
    __syncthreads();                  // the previous stage is consumed
    if (tid < n) {
      const float* r = pack + (base + tid) * kPackCh;
      float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
      Staged st{};
      if (r[9] > 0.0f) {              // ok; an unused row keeps no box
        const Tri t = setup(r);
        st = Staged{t.x0, t.x1, t.x2, t.y0, t.y1, t.y2, t.z0, t.z1, t.z2,
                    t.inv_area, t.apos ? 1.0f : 0.0f, 0.0f};
        box = cover_box(r);
      }
      boxes[tid] = box;
      staged[tid] = st;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float4 b = boxes[s];
      if ((wx1 < b.x) | (wx0 > b.y) | (wy1 < b.z) | (wy0 > b.w)) {
        continue;                     // the same in the whole warp
      }
      const Staged q = staged[s];
      const Tri tri{q.x0, q.x1, q.x2, q.y0, q.y1, q.y2, q.z0, q.z1, q.z2,
                    q.apos != 0.0f, q.inv_area};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float py = static_cast<float>(y_base + i) + 0.5f;
        float w0, w1, w2, d;
        const bool hit = covers(tri, px, py, w0, w1, w2, d);
        if (hit & (d < zbuf[i])) {
          zbuf[i] = d;
          best[i] = base + s;
        }
      }
    }
  }

  const long long out0 =
      static_cast<long long>(tile) * kTilePx + band * kRows * kTileW + tid;
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
