// All-pairs AABB broadphase -> fixed-capacity neighbor lists, for Hopper.
//
// Replaces the TPU kernel `_neighbor_kernel` of
// banggameengine_tpu/physics/broadphase_pallas.py (entry
// `neighbor_lists_pallas_aabb`).  It computes the same thing, written for
// the GPU rather than carried over block by block.
//
// Inputs are already sorted (row i is the i-th body in the caller's order;
// the physics step passes Morton order).  For each row i, a column j passes
// when
//   - the AABBs overlap on all three axes (margin already applied),
//   - dyn_i >= 0 and dyn_j >= 0, and dyn_i > 0 or dyn_j > 0,
//   - (layer_i & mask_j) != 0 and (layer_j & mask_i) != 0,
//   - j != i.
// The first k passing columns, in ascending j, go to idx[i, :], the rest of
// the row is -1, and count[i] is the number of ALL passing columns (those
// beyond k included, so the caller can report the overflow).
//
// Design: block-AABB pruning, as the TPU kernel prunes by 128-body blocks.
//   1. group_bounds_kernel writes the union AABB of every group of kGroup
//      consecutive columns (min of the mins, max of the maxes) to a
//      scratch [n_groups, 6] f32 tensor.
//   2. neighbor_lists_kernel gives each block a band of kBand consecutive
//      rows (8 warps, 8 rows each).  The band's union is the union of its
//      own groups' unions.  The block tests every group's union against
//      the band's, 256 groups at a time, and lists the groups that pass in
//      ascending order.  It stages the columns of kBatch listed groups at a
//      time in shared memory (one column per thread, read once per block,
//      not once per row; the next batch's loads are in flight while this
//      one is tested).  Each warp tests all 64 (row, group) pairs of its 8
//      rows and the batch's 8 groups at once, two per lane, and then walks
//      only the pairs whose row box meets the group's union, row by row
//      and group by group, testing the group's 32 columns, one per lane.
//   3. A warp's __ballot_sync of the lanes that pass, and __popc of the
//      ballot bits below each lane, give every survivor its slot.  Groups
//      are visited in ascending order and a group's columns lie in
//      ascending order across the lanes, so survivors land in ascending j.
//      Lane r of a warp keeps the count of its row r.
//   The output does not depend on the order in which blocks run, so every
//   run gives the same answer.  No padding rule: any n >= 1 and k >= 1.
//
// Why skipping a group changes neither idx nor count:
//   - fminf and fmaxf of f32 values are exact, and each returns the other
//     operand when one is NaN; a union starts from +inf / -inf.  So a
//     group's union holds every non-NaN bound of its columns
//     (group.lo <= c.lo and c.hi <= group.hi on every axis), and the
//     band's union every non-NaN bound of its rows.
//   - A pair that passes has r.lo <= c.hi and c.lo <= r.hi on every axis,
//     all six values non-NaN (a comparison with NaN is false).  Then
//     band.lo <= r.lo <= c.hi <= group.hi and group.lo <= c.lo <= r.hi <=
//     band.hi: the pair's group passes the band test, and the row test
//     (r against the group's union) the same way.
//   - A row or column with a NaN bound fails the pair test against every
//     partner, whatever the unions say; +-inf bounds enter the unions as
//     they are and compare exactly.
//   - So every group that holds a passing column of a row is visited for
//     that row, and a skipped group holds none.  The filter bits (dyn,
//     layer, mask) are not used for pruning.
//
// What bounds it on the card: the all-pairs bound is ~25 integer and float
// operations per (row, column) pair, n^2 of them (0.037 ms at n = 10,000).
// On Morton-sorted, spread-out bodies most (band, group) pairs are pruned
// (the stress scene keeps ~5 %), so the kernel does a fraction of that
// work; what is left is latency: the pre-pass, the group list and one
// staged batch after another in the band that keeps the most groups (a
// band across a jump of the Morton curve).  Without the unions and the
// staging, each row would stream all n columns from L2: 36 n^2 bytes of
// cache traffic, 3.6 GB at n = 10,000.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / kWarp;
constexpr int kGroup = 32;                     // columns per group: a lane each
constexpr int kBand = 64;                      // rows per block
constexpr int kRowsPerWarp = kBand / kWarps;   // 8
constexpr int kBatch = kThreads / kGroup;      // groups staged at a time
constexpr int kBoundsCh = 6;                   // lo x y z, hi x y z
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBand % kGroup == 0, "a band is a run of whole groups");
static_assert(kBand % kWarps == 0, "whole rows per warp");
static_assert(kRowsPerWarp * kBatch == 2 * kWarp,
              "a warp's (row, group) tests are two per lane");

// Whether the boxes [alo, ahi] and [blo, bhi] overlap on all three axes.
__device__ __forceinline__ bool overlaps(const float* alo, const float* ahi,
                                         const float* blo, const float* bhi) {
  return (alo[0] <= bhi[0]) & (blo[0] <= ahi[0]) & (alo[1] <= bhi[1]) &
         (blo[1] <= ahi[1]) & (alo[2] <= bhi[2]) & (blo[2] <= ahi[2]);
}

// One warp per group: the union of the group's column boxes, NaN bounds
// left out (+inf / -inf where every bound of an axis is NaN).
__global__ void __launch_bounds__(kThreads)
group_bounds_kernel(const float* __restrict__ lo,   // [3, n]
                    const float* __restrict__ hi,   // [3, n]
                    int n, int n_groups,
                    float* __restrict__ bounds) {   // [n_groups, 6]
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (g >= n_groups) return;                   // warp-uniform
  const int j = g * kGroup + lane;
  float v[kBoundsCh];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    v[ax] = j < n ? fminf(INFINITY, lo[ax * n + j]) : INFINITY;
    v[3 + ax] = j < n ? fmaxf(-INFINITY, hi[ax * n + j]) : -INFINITY;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      v[ax] = fminf(v[ax], __shfl_xor_sync(kFull, v[ax], off));
      v[3 + ax] = fmaxf(v[3 + ax], __shfl_xor_sync(kFull, v[3 + ax], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kBoundsCh; ++c) bounds[g * kBoundsCh + c] = v[c];
  }
}

// Whether row r of the band (in shared memory) is solid and its box meets
// the union of staged group b.
__device__ __forceinline__ bool row_meets_group(
    const float (*row_box)[kBand], const int (*row_bits)[kBand],
    const float (*group_box)[kBoundsCh], int r, int b) {
  const float rlo[3] = {row_box[0][r], row_box[1][r], row_box[2][r]};
  const float rhi[3] = {row_box[3][r], row_box[4][r], row_box[5][r]};
  return (row_bits[0][r] >= 0) &
         overlaps(rlo, rhi, group_box[b], group_box[b] + 3);
}

__global__ void __launch_bounds__(kThreads)
neighbor_lists_kernel(
    const float* __restrict__ lo,      // [3, n] AABB min planes
    const float* __restrict__ hi,      // [3, n] AABB max planes
    const int* __restrict__ dyn,       // [n] -1 not solid, 0 static, 1 dynamic
    const int* __restrict__ layer,     // [n]
    const int* __restrict__ mask,      // [n]
    const float* __restrict__ bounds,  // [n_groups, 6] group unions
    int n, int n_groups, int k,
    int* __restrict__ idx,             // [n, k]
    int* __restrict__ count) {         // [n]
  __shared__ float row_box[kBoundsCh][kBand];
  __shared__ int row_bits[3][kBand];               // dyn, layer, mask
  __shared__ int visit[kThreads];                  // listed groups, ascending
  __shared__ int warp_total[kWarps];
  __shared__ float col_box[kBoundsCh][kBatch * kGroup];
  __shared__ int col_bits[3][kBatch * kGroup];
  __shared__ float group_box[kBatch][kBoundsCh];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const unsigned below = (1u << lane) - 1u;        // lanes under this one
  const int row0 = blockIdx.x * kBand;
  const int wrow0 = warp * kRowsPerWarp;           // the warp's first row

  if (tid < kBand) {
    const int i = row0 + tid;
    if (i < n) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        row_box[ax][tid] = lo[ax * n + i];
        row_box[3 + ax][tid] = hi[ax * n + i];
      }
      row_bits[0][tid] = dyn[i];
      row_bits[1][tid] = layer[i];
      row_bits[2][tid] = mask[i];
    } else {
      row_bits[0][tid] = -1;                       // no row: no partners
    }
  }

  // the band's union: the union of its own groups' unions
  float band[kBoundsCh] = {INFINITY, INFINITY, INFINITY,
                           -INFINITY, -INFINITY, -INFINITY};
  const int g_lo = row0 / kGroup;
  const int g_hi = min(n_groups, g_lo + kBand / kGroup);
  for (int g = g_lo; g < g_hi; ++g) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      band[ax] = fminf(band[ax], bounds[g * kBoundsCh + ax]);
      band[3 + ax] = fmaxf(band[3 + ax], bounds[g * kBoundsCh + 3 + ax]);
    }
  }

  // lane rr < kRowsPerWarp counts the passing columns of the warp's row rr
  int filled = 0;
  // this thread's column of the next staged batch, loaded ahead
  float nbox[kBoundsCh] = {};
  int nbits[3] = {-1, 0, 0};
  float ngroup = 0.0f;
  auto prefetch = [&](int v0, int total) {
    nbits[0] = -1;
    if (v0 + warp < total) {           // warp w loads listed group v0 + w
      const int gg = visit[v0 + warp];
      const int j = gg * kGroup + lane;
      if (j < n) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          nbox[ax] = lo[ax * n + j];
          nbox[3 + ax] = hi[ax * n + j];
        }
        nbits[0] = dyn[j];
        nbits[1] = layer[j];
        nbits[2] = mask[j];
      }
      if (lane < kBoundsCh) ngroup = bounds[gg * kBoundsCh + lane];
    }
  };

  for (int g0 = 0; g0 < n_groups; g0 += kThreads) {
    // list the groups of this chunk whose union meets the band's
    const int g = g0 + tid;
    bool keep = false;
    if (g < n_groups) {
      const float* gb = bounds + static_cast<long long>(g) * kBoundsCh;
      keep = overlaps(band, band + 3, gb, gb + 3);
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();               // the rows and every warp's total are in
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_total[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (keep) visit[before + __popc(ballot & below)] = g;
    __syncthreads();

    if (total > 0) prefetch(0, total);
    for (int v0 = 0; v0 < total; v0 += kBatch) {
      const int nb = min(kBatch, total - v0);
      const int s = warp * kGroup + lane;          // this thread's column
#pragma unroll
      for (int c = 0; c < kBoundsCh; ++c) col_box[c][s] = nbox[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) col_bits[c][s] = nbits[c];
      if (warp < nb && lane < kBoundsCh) group_box[warp][lane] = ngroup;
      __syncthreads();
      prefetch(v0 + kBatch, total);    // in flight while this batch runs

      // every (row, group) test of the warp's 8 rows and the batch's 8
      // groups at once, two per lane; bit rr * 8 + b of `pairs` is set
      // when row rr meets group b, so the bits run through each row's
      // groups in ascending order
      const int b = lane % kBatch;
      const int rr = lane / kBatch;
      const bool t0 = b < nb && row_meets_group(row_box, row_bits,
                                                group_box, wrow0 + rr, b);
      const bool t1 = b < nb &&
                      row_meets_group(row_box, row_bits, group_box,
                                      wrow0 + rr + kWarp / kBatch, b);
      unsigned long long pairs =
          __ballot_sync(kFull, t0) |
          (static_cast<unsigned long long>(__ballot_sync(kFull, t1))
           << kWarp);
      while (pairs != 0ull) {          // warp-uniform
        const int bit = __ffsll(static_cast<long long>(pairs)) - 1;
        pairs &= pairs - 1ull;
        const int pr = bit / kBatch, pb = bit % kBatch;
        const int r = wrow0 + pr;
        const int i = row0 + r;
        const int rd = row_bits[0][r], rl = row_bits[1][r];
        const int rm = row_bits[2][r];
        const int cs = pb * kGroup + lane;
        const int j = visit[v0 + pb] * kGroup + lane;
        const int cd = col_bits[0][cs];
        const bool ov =
            (row_box[0][r] <= col_box[3][cs]) &
            (col_box[0][cs] <= row_box[3][r]) &
            (row_box[1][r] <= col_box[4][cs]) &
            (col_box[1][cs] <= row_box[4][r]) &
            (row_box[2][r] <= col_box[5][cs]) &
            (col_box[2][cs] <= row_box[5][r]) &
            (cd >= 0) & ((rd > 0) | (cd > 0)) &
            ((rl & col_bits[2][cs]) != 0) & ((col_bits[1][cs] & rm) != 0) &
            (j != i);
        const unsigned hits = __ballot_sync(kFull, ov);
        const int before_row = __shfl_sync(kFull, filled, pr);
        if (ov) {
          const int slot = before_row + __popc(hits & below);
          if (slot < k) idx[static_cast<long long>(i) * k + slot] = j;
        }
        if (lane == pr) filled += __popc(hits);
      }
      __syncthreads();             // the staged batch is consumed
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = row0 + wrow0 + rr;
    const int f = __shfl_sync(kFull, filled, rr);
    if (i >= n) continue;
    for (int s = f + lane; s < k; s += kWarp) {
      idx[static_cast<long long>(i) * k + s] = -1;
    }
    if (lane == 0) count[i] = f;
  }
}

}  // namespace

// Launches the union pre-pass and the kernel on `stream` and returns
// cudaGetLastError() as an int (0 = launched).  Pointers are device
// pointers the caller allocated; `bounds` is scratch of
// ceil(n / kGroup) * 6 floats.
extern "C" int neighbor_lists_launch(const float* lo, const float* hi,
                                     const int* dyn, const int* layer,
                                     const int* mask, int n, int k,
                                     float* bounds, int* idx, int* count,
                                     void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = (n + kGroup - 1) / kGroup;
  group_bounds_kernel<<<(n_groups + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      lo, hi, n, n_groups, bounds);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  neighbor_lists_kernel<<<(n + kBand - 1) / kBand, kThreads, 0, s>>>(
      lo, hi, dyn, layer, mask, bounds, n, n_groups, k, idx, count);
  return static_cast<int>(cudaGetLastError());
}

// The group and band sizes the kernel was built with (columns per group,
// rows per band), for the wrapper's scratch and the plain pruning helper.
extern "C" void neighbor_lists_shape(int* group, int* band) {
  *group = kGroup;
  *band = kBand;
}

extern "C" const char* neighbor_lists_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
