// Kernel K8 of the PyTorch/CUDA port: the word-wise AND of two bitmaps and
// the number of bits set in it,
//
//   out[i] = a[i] & b[i],     count = sum_i popcount(out[i])   (mod 2^32)
//
// over N uint32 words ([MC07] hybrid bitmaps: the AND intersects the two
// encoded sets, the count is the result's size).
//
// Replaces the TPU kernel
//   src/repro/kernels/bitmap_and/bitmap_and.py:36 bitmap_and_pallas
// (body _bitmap_and_kernel, :29), and must equal
// kernels/bitmap_and/ops.py bitmap_and_plain exactly.
//
// What bounds it on Hopper: bytes.  Two words read and one written per 32
// documents, a few operations each: at the repair-ir universe of 2^25
// documents (1,048,576 words) that is 12.6 MB, about 0.004 ms at
// 3.35 TB/s, so the launch itself costs more than the work.
//
// What the design does about it:
// * A grid-stride loop over 16-byte groups (four words a thread a step,
//   neighbouring threads on neighbouring addresses), with a scalar path
//   for an unaligned operand and for the tail of N mod 4 words.
// * The popcount is __popc on each word, summed in a register, reduced
//   over the warp with shuffles and over the block in shared memory, then
//   added to the total by one atomicAdd per block.  Integer atomics make
//   the total exact in any order of the blocks.  The TPU kernel's
//   per-tile count array existed only because a TPU grid step writes its
//   own output block; the wrappers' contract is one total, so the card
//   keeps one int.
// * count may be null (the plain AND): the popcount is then skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8 * 132;            // 8 resident blocks per SM
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
bitmap_and_kernel(const unsigned* __restrict__ a,
                  const unsigned* __restrict__ b, unsigned* __restrict__ out,
                  unsigned* __restrict__ count, int n, int vec) {
  __shared__ unsigned s_warp[kThreads / 32];
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  unsigned bits = 0;
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int i = tid; i < n4; i += stride) {
      const uint4 x = a4[i], y = b4[i];
      const uint4 w = make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
      o4[i] = w;
      bits += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    }
    done = n4 << 2;
  }
  for (int i = done + tid; i < n; i += stride) {
    const unsigned w = a[i] & b[i];
    out[i] = w;
    bits += __popc(w);
  }
  if (count == nullptr) return;                // uniform over the grid
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(kFull, bits, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = bits;
  __syncthreads();
  if (warp == 0) {
    bits = lane < kThreads / 32 ? s_warp[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(kFull, bits, o);
    if (lane == 0 && bits) atomicAdd(count, bits);
  }
}

}  // namespace

// count: one int of the output, zeroed here first; null for the plain AND.
extern "C" int bitmap_and_launch(const unsigned* a, const unsigned* b,
                                 unsigned* out, int* count, int n,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* total = reinterpret_cast<unsigned*>(count);
  if (total != nullptr) {
    const cudaError_t err = cudaMemsetAsync(total, 0, sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int vec = ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int per_thread = vec ? 4 : 1;
  int blocks = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  bitmap_and_kernel<<<blocks, kThreads, 0, s>>>(a, b, out, total, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitmap_and_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
