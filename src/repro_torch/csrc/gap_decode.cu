// Kernel K6 of the PyTorch/CUDA port: row-wise d-gap decode,
//
//   out[r, t] = firsts[r] + gaps[r, 0] + ... + gaps[r, t]    (mod 2^32)
//
// an inclusive prefix sum of each row plus the row's first value, in
// wrapping int32 arithmetic (as JAX's int32 cumsum wraps).
//
// Replaces the TPU kernel
//   src/repro/kernels/gap_decode/gap_decode.py:39 gap_decode_pallas
// (body _gap_decode_kernel, :26), and must equal
// kernels/gap_decode/ops.py gap_decode_plain exactly.
//
// What bounds it on Hopper: bytes.  Each gap is read once and each id
// written once, one add per element: at the reference's decode_bulk shape
// (16,384 x 4,096) that is 2 x 268 MB, about 0.16 ms at 3.35 TB/s.
//
// What the design does about it:
// * On the TPU the column tiles ran in order, so a VMEM scratch carried
//   each row's running sum from one grid step to the next.  Blocks on
//   Hopper run in no order, so the carry becomes a loop inside the block:
//   one warp owns one row and walks it in chunks, its running sum in a
//   register.
// * A chunk is 32 lanes x 4 values: each lane loads 16 bytes (neighbouring
//   lanes on neighbouring addresses), scans its 4 values, and a 5-step
//   warp shuffle scan adds the lanes' totals; lane 31's inclusive sum
//   moves the carry.  A row whose start is not 16-byte aligned (C not a
//   multiple of 4) takes the scalar path, 32 values a chunk; so does the
//   tail of C mod 4 values of an aligned row.
// * Sums are uint32_t, so they wrap as int32 does in JAX; signed overflow
//   would be undefined in C++.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps = 8 rows a block
constexpr int kRows = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive warp scan of v; every lane gets its own prefix.
__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
gap_decode_kernel(const int* __restrict__ gaps,
                  const int* __restrict__ firsts, int* __restrict__ out,
                  int R, int C) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;                        // whole warps leave together
  const unsigned* g =
      reinterpret_cast<const unsigned*>(gaps) + size_t(row) * C;
  unsigned* o = reinterpret_cast<unsigned*>(out) + size_t(row) * C;
  unsigned carry = static_cast<unsigned>(firsts[row]);
  int done = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (aligned) {
    const int n4 = C >> 2;                     // whole 16-byte groups
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int base = 0; base < n4; base += 32) {
      const int i = base + lane;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < n4) v = g4[i];
      v.y += v.x;
      v.z += v.y;
      v.w += v.z;
      const unsigned incl = warp_scan(v.w, lane);
      const unsigned add = carry + incl - v.w; // carry + lanes before mine
      if (i < n4)
        o4[i] = make_uint4(v.x + add, v.y + add, v.z + add, v.w + add);
      carry += __shfl_sync(kFull, incl, 31);
    }
    done = n4 << 2;
  }
  for (int base = done; base < C; base += 32) {  // scalar rows and tails
    const int i = base + lane;
    const unsigned v = i < C ? g[i] : 0u;
    const unsigned incl = warp_scan(v, lane);
    if (i < C) o[i] = carry + incl;
    carry += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

extern "C" int gap_decode_launch(const int* gaps, const int* firsts,
                                 int* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + kRows - 1) / kRows;
  gap_decode_kernel<<<blocks, kThreads, 0, s>>>(gaps, firsts, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gap_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
