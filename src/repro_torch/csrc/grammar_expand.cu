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
// Wants are int32 and wrap as the reference's do.
//
// Replaces the TPU kernel
//   src/repro/kernels/grammar_expand/grammar_expand.py:70
//   grammar_expand_pallas (body _expand_kernel, :39),
// and must equal kernels/grammar_expand/ops.py grammar_expand_plain
// exactly.
//
// What bounds it on Hopper: bytes.  Each symbol reads 4 bytes and writes
// its 128-byte row; the grammar nodes its expansion visits are read from
// the four tables (16 bytes a node), which stay in the 50 MB L2.  Only the
// slots within a phrase's length need a descent: 7% of them on the served
// stream, whose phrases average 2.2 gaps.
//
// What the design does about it:
// * The TPU gathered by one-hot masked sums over the whole table, one
//   lane per slot.  The first design here kept one thread per slot: 44
//   waves of the card, each lane a chain of dependent loads, and 93% of
//   the lanes only wrote a zero.
// * A warp takes 8 rows.  Lane i < 8 reads its row's symbol and the
//   symbol's four entries in one round.  A terminal (or any symbol at
//   max_depth 0) is its own sum and fills its row at once; the slots
//   below a rule are counted, scanned across the warp, and dealt to the
//   warp's 32 lanes in turn: each lane runs the reference's descent for
//   one slot, so the kernel equals the reference on any tables (lens
//   that disagree with the children's, wants that wrap, a cut at any
//   depth).  A descent step loads both children's entries with the
//   split's length: one round of loads a level.
// * Warp k takes rows k, k + warps, k + 2 * warps, ...: the served
//   stream keeps long phrases together, and a warp of neighbours waited
//   on its longest row.  Spread over the stream, the warps' shares of
//   slots even out.
// * A row is one 128-byte line of out.  The warp writes its rows' slots
//   into a shared-memory tile (33 words a row, so lanes on one slot fall
//   in different banks), and after a __syncwarp stores each row with
//   eight 16-byte evict-first stores, zeros past its length filled in on
//   the way: no block barrier, no zero pass.
// * Variants timed on the card against a capture of the main launch lost:
//   one thread per symbol visiting each node once (a phrase of 32 gaps is
//   a chain of 63 node visits), 4, 16 or 32 rows a warp, 256-thread
//   blocks, the children's sums loaded with every step, plain stores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCap = 32;                       // PHRASE_CAP: slots a symbol
constexpr int kStride = kCap + 1;              // a row of the tile, padded
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                       // symbols a warp

struct Tables {
  const int* __restrict__ left;
  const int* __restrict__ right;
  const int* __restrict__ sums;
  const int* __restrict__ lens;
  int S;
};

__device__ __forceinline__ int read(const int* __restrict__ t, int i, int S,
                                    int pad) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(S) ? __ldg(t + i)
                                                             : pad;
}

// The reference's descent of one valid slot, want = slot + 1, from a rule
// x whose children l, r are known.  Each step loads both children's
// entries with the split's length, so a level is one round of loads.
// Returns the sum where the slot ends.
__device__ __forceinline__ int descend(int x, int l, int r, int want,
                                       const Tables& t, int max_depth) {
  for (int d = 0; d < max_depth && l >= 0; ++d) {
    const int ll = read(t.lens, l, t.S, 1);
    const int l_left = read(t.left, l, t.S, -1);
    const int l_right = read(t.right, l, t.S, -1);
    const int r_left = read(t.left, r, t.S, -1);
    const int r_right = read(t.right, r, t.S, -1);
    if (want <= ll) {
      x = l;
      l = l_left;
      r = l_right;
    } else {                                   // int32 wrap, as the reference
      want = static_cast<int>(static_cast<unsigned>(want) -
                              static_cast<unsigned>(ll));
      x = r;
      l = r_left;
      r = r_right;
    }
  }
  return read(t.sums, x, t.S, 0);
}

__global__ void __launch_bounds__(kThreads)
grammar_expand_kernel(const int* __restrict__ syms, Tables t,
                      int* __restrict__ out, int W, int max_depth) {
  __shared__ int tile[kWarps][kRows * kStride];
  __shared__ int ends[kWarps][kRows];          // inclusive scan of the slots
  __shared__ int4 roots[kWarps][kRows];        // each row's x, left, right, n
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps =
      static_cast<int>((static_cast<long long>(W) + kRows - 1) / kRows);
  const int k = blockIdx.x * kWarps + warp;
  if (k >= warps) return;
  // lane i < kRows of warp k owns row w = i * warps + k: rows far apart in
  // the stream, so a run of long phrases is spread over many warps
  const long long w = static_cast<long long>(lane) * warps + k;
  const bool own = lane < kRows && w < W;
  int* row = tile[warp] + lane * kStride;
  const int x = own ? syms[w] : 0;
  const int len = read(t.lens, x, t.S, 1);
  const int l = read(t.left, x, t.S, -1);
  const int r = read(t.right, x, t.S, -1);
  const int sum = read(t.sums, x, t.S, 0);
  const int n = !own || len < 0 ? 0 : (len > kCap ? kCap : len);
  // a terminal, or any symbol at max_depth 0, is its own sum: no descent
  const bool leaf = l < 0 || max_depth <= 0;
  if (leaf)
    for (int p = 0; p < n; ++p) row[p] = sum;
  int end = leaf ? 0 : n;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, end, o);
    if (lane >= o) end += v;
  }
  const int total = __shfl_sync(0xffffffffu, end, 31);
  if (lane < kRows) {
    ends[warp][lane] = end;
    roots[warp][lane] = make_int4(x, l, r, n);
  }
  __syncwarp();
  // the warp's slots below a rule, dealt to its lanes in turn
  for (int j = lane; j < total; j += 32) {
    int i = 0;                                 // first row whose end > j
    for (int step = kRows / 2; step > 0; step >>= 1)
      if (ends[warp][i + step - 1] <= j) i += step;
    const int p = j - (i ? ends[warp][i - 1] : 0);
    const int4 root = roots[warp][i];
    tile[warp][i * kStride + p] =
        descend(root.x, root.y, root.z, p + 1, t, max_depth);
  }
  __syncwarp();
  // each row is one 128-byte line of out: eight 16-byte stores from eight
  // lanes, four rows an instruction, evict-first (nothing reads them
  // here); slots past the row's length are zeros, never written above
  for (int v = lane; v < kRows * (kCap / 4); v += 32) {
    const long long wv = static_cast<long long>(v >> 3) * warps + k;
    if (wv >= W) break;
    const int* src = tile[warp] + (v >> 3) * kStride + (v & 7) * 4;
    const int c = roots[warp][v >> 3].w - (v & 7) * 4;
    __stcs(reinterpret_cast<int4*>(out + wv * kCap) + (v & 7),
           make_int4(c > 0 ? src[0] : 0, c > 1 ? src[1] : 0,
                     c > 2 ? src[2] : 0, c > 3 ? src[3] : 0));
  }
}

}  // namespace

extern "C" int grammar_expand_launch(const int* syms, const int* left,
                                     const int* right, const int* sums,
                                     const int* lens, int* out, int W, int S,
                                     int max_depth, void* stream) {
  if (W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t{left, right, sums, lens, S};
  const long long warps = (static_cast<long long>(W) + kRows - 1) / kRows;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) /
                                                kWarps);
  grammar_expand_kernel<<<blocks, kThreads, 0, s>>>(syms, t, out, W,
                                                    max_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grammar_expand_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
