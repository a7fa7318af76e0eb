// Row gather of a u8 table, out[i] = table[idx[i]], for Hopper.
//
// Replaces the TPU kernel `gather_kernel` of scripts/profile_shade_parts.py
// (entry `pl_gather`), a probe that gathers the 16 texel bytes of each
// pixel's bilinear quad from a VMEM-resident table.  The contract is the
// kernel body's `jnp.take(table, idx, axis=0)` in its default mode:
//
//   ok  = -r <= idx[i] < r
//   row = idx[i] < 0 ? idx[i] + r : idx[i]
//   out[i][b] = ok ? table[row][b] : 255          for b in [0, w)
//
//   table [r, w] u8, idx [p] i32, out [p, w] u8
//
// Design: one thread per output row.  When w == 16 and both pointers are
// 16-byte aligned, a row is one 128-bit read-only load (__ldg of a uint4)
// and one 128-bit store; otherwise a byte loop.  What bounds it: the bytes,
// 4 + 16 per output row plus each distinct table row read once (at the
// probe's 1080p shape, 2,073,600 rows from an 8 MB table: ~50 MB, ~15 us
// at 3.35 TB/s).  The table fits in the 50 MB L2, so its re-reads are L2
// sector reads; the TPU kernel's VMEM-resident table and 8192-row blocks
// have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint8_t* __restrict__ table,
                   const int* __restrict__ idx, long long p, int r, int w,
                   uint8_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= p) return;
  const int k = idx[i];
  const bool ok = (k >= -r) & (k < r);
  // row 0 stands in for a bad index, so no load leaves the table
  const long long row = !ok ? 0 : k < 0 ? static_cast<long long>(k) + r : k;
  if (kVec16) {
    const uint4 fill = make_uint4(~0u, ~0u, ~0u, ~0u);
    reinterpret_cast<uint4*>(out)[i] =
        ok ? __ldg(reinterpret_cast<const uint4*>(table) + row) : fill;
  } else {
    const uint8_t* src = table + row * w;
    uint8_t* dst = out + i * w;
    for (int b = 0; b < w; ++b) {
      dst[b] = ok ? __ldg(src + b) : static_cast<uint8_t>(255);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers the caller allocated.
extern "C" int gather_rows_launch(const uint8_t* table, const int* idx,
                                  long long p, int r, int w, uint8_t* out,
                                  void* stream) {
  if (p < 1 || r < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((p + kThreads - 1) / kThreads);
  const bool vec16 = w == 16 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16) {
    gather_rows_kernel<true><<<blocks, kThreads, 0, s>>>(table, idx, p, r, w,
                                                         out);
  } else {
    gather_rows_kernel<false><<<blocks, kThreads, 0, s>>>(table, idx, p, r,
                                                          w, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
