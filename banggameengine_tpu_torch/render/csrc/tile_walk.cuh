// The banded visibility walk that raster_walk.cu, raster_resolve.cu and
// raster_tile.cu share: the coverage test of one binned slot at one pixel,
// the cover box outside which a slot covers no pixel, and the loop that
// walks one band of 4 pixel rows of a 32x128-pixel tile over the tile's
// slots.
//
// A slot's row: x0 x1 x2 y0 y1 y2 (screen coords) z0 z1 z2 (NDC depth), and
// whether it is used.  Where the rows come from is the kernel's: band_walk
// takes a loader (PackRows below for the packed rows of #3 and #4; the
// full-carry raster's x, y, z and ok arrays in raster_tile.cu).
//
// Pixel p of a block's tile at screen tile t sits at x = (t % tiles_x) *
// 128 + p % 128 + 0.5, y = (t / tiles_x) * 32 + p / 128 + 0.5.  A slot
// covers a pixel when the three edge functions agree in sign with the
// triangle's area (two-sided), and its barycentric depth w0*z0 + w1*z1 +
// w2*z2 lies in [0, 1].
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
// Then covers() is deterministic: the same row at the same pixel gives the
// same weights wherever it is called.
//
// What bounds the walk: ~33 f32 operations per (pixel, used slot).  The
// work is uneven: most tiles walk ~20-30 slots, the densest 246 (the
// showcase) or 272 (the 10k-box view).  One block per tile would leave the
// densest tile's block to set the time, 8 warps on one SM while the other
// SMs sit idle.  The design, for the densest tiles:
//   - Pixel bands.  A tile's 32 pixel rows are split over kBands blocks of
//     128 threads; thread x owns the kRows pixels of column x in its band,
//     in registers.  The kernels' grids are tile by tile, band fastest, so
//     a dense tile's bands start on different SMs side by side.  Of 1, 2,
//     4 and 8 rows a band, 4 was the fastest on both 1080p views.
//   - Set up once.  Every block stages its tile's rows 128 slots at a time;
//     each staging thread sets its slot up (setup(): corners, the sign of
//     the area, the area's inverse) and computes its cover box (below) once
//     for every pixel of the band.
//   - Warp footprints.  A warp's pixels fill a 32 x kRows rectangle.  A
//     slot whose cover box misses the rectangle covers none of them, and
//     the warp skips it with four compares instead of 33 operations a
//     pixel.  An unused row gets an empty box.
//   Each pixel still walks the slots that can cover it in ascending order
//   and takes a slot only when strictly nearer, with covers(), so depth and
//   slot are those of the plain version, bit for bit.
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

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tile_walk {

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kPackCh = 16;
constexpr int kCorners = 9;                  // x0..z2
constexpr int kWarp = 32;
constexpr int kRows = 4;                     // pixel rows per band (block)
constexpr int kBands = kTileH / kRows;
constexpr int kBandThreads = kTileW;         // one thread per pixel column
constexpr int kBandStage = kBandThreads;     // slots set up at a time
constexpr double kCoverErr = 0x1p-21;        // 8u: twice the edge error's 4u
constexpr double kCoverMaxCoord = 1e7;       // pixels, for a bounded slot
constexpr double kCoverMinArea = 1e-6;       // square pixels, the same

// One slot, set up for every pixel: its corners, the sign of its area and
// the area's inverse.
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

// One slot as band_walk stages it (a Tri in 16-byte-aligned floats).
struct alignas(16) Staged {
  float x0, x1, x2, y0, y1, y2, z0, z1, z2, inv_area, apos, pad;
};

// The rows of one packed tile, tri_pack [k_pad, 16]: slot s is used when
// its ok column (9) is > 0.
struct PackRows {
  const float* pack;

  // Whether slot s is used; if it is, its corners go to r.
  __device__ __forceinline__ bool load(int s, float (&r)[kCorners]) const {
    const float* p = pack + s * kPackCh;
    if (!(__ldg(p + 9) > 0.0f)) return false;
#pragma unroll
    for (int j = 0; j < kCorners; ++j) r[j] = __ldg(p + j);
    return true;
  }
};

// Walks slots 0 .. walked-1 of one tile for the band of kRows pixel rows
// from screen row y_base, over pixel columns x_base .. x_base + 127, one
// column per thread, and leaves each of the thread's pixels' best depth
// (INFINITY where none) in zbuf and slot (-1 where none) in best.  `rows`
// says whether a slot is used and loads its corners (PackRows' `load`).
// Every thread of the block (kBandThreads) must call it.
template <class Rows>
__device__ __forceinline__ void band_walk(const Rows& rows, int walked,
                                          int x_base, int y_base,
                                          float (&zbuf)[kRows],
                                          int (&best)[kRows]) {
  __shared__ float4 boxes[kBandStage];
  __shared__ Staged staged[kBandStage];
  const int tid = threadIdx.x;
  const float px = static_cast<float>(x_base + tid) + 0.5f;
  // the warp's footprint: pixel centres wx0..wx1 x wy0..wy1
  const float wx0 =
      static_cast<float>(x_base + (tid & ~(kWarp - 1))) + 0.5f;
  const float wx1 = wx0 + static_cast<float>(kWarp - 1);
  const float wy0 = static_cast<float>(y_base) + 0.5f;
  const float wy1 = wy0 + static_cast<float>(kRows - 1);

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    zbuf[i] = INFINITY;
    best[i] = -1;
  }
  for (int base = 0; base < walked; base += kBandStage) {
    const int n = min(kBandStage, walked - base);
    __syncthreads();                  // the previous stage is consumed
    if (tid < n) {
      float r[kCorners];
      float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
      Staged st{};
      if (rows.load(base + tid, r)) {   // an unused row keeps no box
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
}

}  // namespace tile_walk
