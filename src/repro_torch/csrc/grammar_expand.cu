// Kernel K5 of the PyTorch/CUDA port: positional Re-Pair phrase expansion.
// Output slot (w, p), p < 32, holds the (p+1)-th gap of symbol syms[w]'s
// expansion, and 0 past the symbol's expanded length:
//
//   sym = syms[w], want = p + 1, valid = want <= lens[sym]
//   max_depth times: if left[sym] >= 0 (a rule):
//       if want <= lens[left[sym]]: sym = left[sym]
//       else: want -= lens[left[sym]], sym = right[sym]
//   out[w, p] = valid ? sums[sym] : 0
//
// A lane still on a rule after max_depth steps outputs that rule's sum, as
// the reference does.  A symbol id outside [0, S) reads as a padded table
// slot (left = right = -1, sum 0, len 1), as the reference's padding does.
//
// Replaces the TPU kernel
//   src/repro/kernels/grammar_expand/grammar_expand.py:70
//   grammar_expand_pallas (body _expand_kernel, :39),
// and must equal kernels/grammar_expand/ops.py grammar_expand_plain
// exactly.
//
// What bounds it on Hopper: bytes.  Each slot writes 4 bytes and each
// symbol reads 4; the descents read the four tables at the grammar nodes
// they visit (16 bytes a node), which stay in the 50 MB L2.
//
// What the design does about it:
// * The TPU has no dynamic gather from VMEM, so the Pallas kernel gathered
//   by one-hot masked sums over the whole table (TILE_W * 32 x S compares
//   a step).  Here every read is a real gather through the read-only
//   cache.
// * One thread per output slot, 32 slots a symbol: a warp is one symbol's
//   row, so the row is stored as one coalesced 128-byte line and the
//   warp's first descent steps read the same nodes.
// * The loop stops early only when the lane stands on a terminal, where
//   the reference's state no longer changes; it never takes more than
//   max_depth steps, so a cut max_depth gives the reference's answer.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 32;                       // PHRASE_CAP: slots a symbol

__device__ __forceinline__ int read(const int* __restrict__ t, int i, int S,
                                    int pad) {
  return (i >= 0 && i < S) ? __ldg(t + i) : pad;
}

__global__ void __launch_bounds__(kThreads)
grammar_expand_kernel(const int* __restrict__ syms,
                      const int* __restrict__ left,
                      const int* __restrict__ right,
                      const int* __restrict__ sums,
                      const int* __restrict__ lens, int* __restrict__ out,
                      long long slots, int S, int max_depth) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= slots) return;
  int sym = syms[t / kCap];
  int want = static_cast<int>(t % kCap) + 1;
  const bool valid = want <= read(lens, sym, S, 1);
  for (int d = 0; d < max_depth; ++d) {
    const int l = read(left, sym, S, -1);
    if (l < 0) break;                          // a terminal: state is fixed
    const int ll = read(lens, l, S, 1);
    if (want <= ll) {
      sym = l;
    } else {
      want -= ll;
      sym = read(right, sym, S, -1);
    }
  }
  out[t] = valid ? read(sums, sym, S, 0) : 0;
}

}  // namespace

extern "C" int grammar_expand_launch(const int* syms, const int* left,
                                     const int* right, const int* sums,
                                     const int* lens, int* out, int W, int S,
                                     int max_depth, void* stream) {
  if (W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slots = static_cast<long long>(W) * kCap;
  const unsigned blocks =
      static_cast<unsigned>((slots + kThreads - 1) / kThreads);
  grammar_expand_kernel<<<blocks, kThreads, 0, s>>>(
      syms, left, right, sums, lens, out, slots, S, max_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grammar_expand_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
