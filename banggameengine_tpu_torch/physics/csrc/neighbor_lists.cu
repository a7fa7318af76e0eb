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
// Design: one warp per row.  The 32 lanes stride over j in steps of 32; a
// __ballot_sync of the lanes that pass, and __popc of the ballot bits below
// each lane, give every survivor its slot, so survivors land in ascending
// j.  The output does not depend on the order in which warps run, so every
// run gives the same answer.  No padding rule: any n >= 1 and k >= 1.
//
// What bounds it on the card: every warp streams all n columns (9 words
// each) through L1/L2, so a launch moves about 36 n^2 bytes from cache and
// does ~n^2 cheap compares: 3.6 GB of cache traffic at n = 10,000.  The
// TPU kernel skipped whole column chunks by block AABB; that pruning, and
// staging column tiles in shared memory, are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 rows per block

__global__ void neighbor_lists_kernel(
    const float* __restrict__ lo,     // [3, n] AABB min planes
    const float* __restrict__ hi,     // [3, n] AABB max planes
    const int* __restrict__ dyn,      // [n] -1 not solid, 0 static, 1 dynamic
    const int* __restrict__ layer,    // [n]
    const int* __restrict__ mask,     // [n]
    int n, int k,
    int* __restrict__ idx,            // [n, k]
    int* __restrict__ count) {        // [n]
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= n) return;              // warp-uniform: the whole warp leaves
  const int i = static_cast<int>(warp);

  const float rx0 = lo[i], ry0 = lo[n + i], rz0 = lo[2 * n + i];
  const float rx1 = hi[i], ry1 = hi[n + i], rz1 = hi[2 * n + i];
  const int rd = dyn[i], rl = layer[i], rm = mask[i];
  const unsigned below = (1u << lane) - 1u;   // lanes under this one

  int filled = 0;
  if (rd >= 0) {                      // a non-solid row has no partners
    for (int j0 = 0; j0 < n; j0 += kWarp) {
      const int j = j0 + lane;
      bool ov = false;
      if (j < n) {
        const int cd = dyn[j];
        ov = (rx0 <= hi[j]) & (lo[j] <= rx1) &
             (ry0 <= hi[n + j]) & (lo[n + j] <= ry1) &
             (rz0 <= hi[2 * n + j]) & (lo[2 * n + j] <= rz1) &
             (cd >= 0) & ((rd > 0) | (cd > 0)) &
             ((rl & mask[j]) != 0) & ((layer[j] & rm) != 0) & (j != i);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, ov);
      if (ov) {
        const int slot = filled + __popc(ballot & below);
        if (slot < k) idx[static_cast<long long>(i) * k + slot] = j;
      }
      filled += __popc(ballot);
    }
  }
  for (int s = filled + lane; s < k; s += kWarp) {
    idx[static_cast<long long>(i) * k + s] = -1;
  }
  if (lane == 0) count[i] = filled;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated.
extern "C" int neighbor_lists_launch(const float* lo, const float* hi,
                                     const int* dyn, const int* layer,
                                     const int* mask, int n, int k, int* idx,
                                     int* count, void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kThreads / kWarp;
  const unsigned blocks =
      static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block);
  neighbor_lists_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lo, hi, dyn, layer, mask, n, k, idx, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* neighbor_lists_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
