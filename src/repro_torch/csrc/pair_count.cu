// Kernel K4 of the PyTorch/CUDA port: exact counts of K candidate pairs
// over the N adjacent-pair slots of Re-Pair's working sequence,
//
//   counts[k] = #{ i : vm[i] != 0 && pa[i] == ca[k] && pb[i] == cb[k] }
//
// and 0 where ca[k] < 0 (an unused table slot).  Duplicate candidates get
// the full count each; K and N are any lengths; candidates in any order.
//
// Replaces the TPU kernel
//   src/repro/kernels/pair_count/pair_count.py:50 pair_count_pallas
// (launched by src/repro/build/pallas_builder.py:49 _count_ranked_pallas),
// and must equal kernels/pair_count/ops.py pair_count_plain exactly.
//
// What bounds it on Hopper: bytes.  The function reads 12 bytes per slot
// (left, right, validity) and does a few integer operations per slot; at
// N ~ 1M slots that is ~11 MB, a few microseconds of HBM time, while the
// candidate table (K = 4096 keys, 32 KB) fits in one block's shared memory.
//
// What the design does about it:
// * The TPU kernel compared every candidate with every slot, a
//   (TILE_K, TILE_N) all-pairs sweep (K * N = 3.9e9 compares per round at
//   K = 4096, N = 954k) because a TPU has no cheap gather.  Here each slot
//   binary-searches its 64-bit key (a << 32 | b) in the sorted candidate
//   table held in shared memory: log2(K) = 12 steps, O(N log K) in all.
// * The candidate table is sorted on the card without a sort: a key's
//   position is its rank, #{j : key_j < key_k} + #{j < k : key_j == key_k},
//   counted by a K x K compare over 256 x 256 tiles (K^2 = 1.7e7 compares
//   at K = 4096, spread over 256 blocks).  The first term is also the
//   position of the key's first copy, where its count accumulates, so a
//   duplicate reads the same count back.
// * Each block counts its contiguous range of the stream into a shared
//   histogram with shared-memory atomics, then adds its nonzero bins to a
//   global histogram with global atomics.  Integer atomics are exact and
//   order-free: the counts do not depend on the schedule.
// * A table longer than one chunk (4096 keys, 48 KB of shared memory with
//   its histogram) is cut into chunks on the grid's y axis; a key whose
//   run of copies starts in an earlier chunk is counted only there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;          // candidate keys per block (32 KB)
constexpr int kMaxBlocks = 4 * 132;   // count blocks: 4 resident per SM

__device__ __forceinline__ long long pair_key(int a, int b) {
  return static_cast<long long>(a) * 4294967296LL +
         static_cast<long long>(static_cast<unsigned>(b));
}

// rank[k] += #{j in tile : key_j < key_k}, eq[k] += #{j in tile, j < k :
// key_j == key_k}; blockIdx.x tiles k, blockIdx.y tiles j.
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int* __restrict__ ca, const int* __restrict__ cb, int K,
            int* __restrict__ rank, int* __restrict__ eq) {
  __shared__ long long tile[kThreads];
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = blockIdx.y * kThreads;
  const int jn = min(kThreads, K - j0);
  if (threadIdx.x < jn)
    tile[threadIdx.x] = pair_key(ca[j0 + threadIdx.x], cb[j0 + threadIdx.x]);
  __syncthreads();
  if (k >= K) return;
  const long long key = pair_key(ca[k], cb[k]);
  int less = 0, before = 0;
  for (int t = 0; t < jn; ++t) {
    const long long other = tile[t];
    less += other < key;
    before += (other == key) & (j0 + t < k);
  }
  if (less) atomicAdd(rank + k, less);
  if (before) atomicAdd(eq + k, before);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ ca, const int* __restrict__ cb, int K,
               const int* __restrict__ rank, const int* __restrict__ eq,
               long long* __restrict__ sorted) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k < K) sorted[rank[k] + eq[k]] = pair_key(ca[k], cb[k]);
}

// Block (x, y) counts stream slots [x * per_block, (x + 1) * per_block)
// against sorted keys [y * kChunk, (y + 1) * kChunk).
__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ sorted, int K,
             const int* __restrict__ pa, const int* __restrict__ pb,
             const int* __restrict__ vm, int n, int per_block,
             int* __restrict__ hist) {
  __shared__ long long s_key[kChunk];
  __shared__ int s_hist[kChunk];
  const int c0 = blockIdx.y * kChunk;
  const int m = min(kChunk, K - c0);
  for (int j = threadIdx.x; j < m; j += kThreads) {
    s_key[j] = sorted[c0 + j];
    s_hist[j] = 0;
  }
  __syncthreads();
  const long long lo = s_key[0], hi = s_key[m - 1];
  const long long before = c0 > 0 ? sorted[c0 - 1] : lo;
  const int begin = blockIdx.x * per_block;
  const int end = min(n, begin + per_block);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    if (vm[i] == 0) continue;
    const long long key = pair_key(pa[i], pb[i]);
    if (key < lo || key > hi) continue;
    int l = 0, r = m - 1;                 // first position with key >= key
    while (l < r) {
      const int mid = (l + r) >> 1;
      if (s_key[mid] < key) l = mid + 1; else r = mid;
    }
    if (s_key[l] != key) continue;
    if (l == 0 && c0 > 0 && before == key) continue;  // an earlier chunk's
    atomicAdd(s_hist + l, 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads)
    if (s_hist[j]) atomicAdd(hist + c0 + j, s_hist[j]);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ ca, int K, const int* __restrict__ rank,
              const int* __restrict__ hist, int* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k < K) out[k] = ca[k] < 0 ? 0 : hist[rank[k]];
}

}  // namespace

// aux: 3 * K ints of scratch (rank, eq, hist); sorted: K long longs.
extern "C" int pair_count_launch(const int* ca, const int* cb, const int* pa,
                                 const int* pb, const int* vm,
                                 long long* sorted, int* aux, int* out, int K,
                                 int n, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* rank = aux;
  int* eq = aux + K;
  int* hist = aux + 2 * K;
  cudaError_t err = cudaMemsetAsync(aux, 0, sizeof(int) * 3 * size_t(K), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kb = (K + kThreads - 1) / kThreads;
  rank_kernel<<<dim3(kb, kb), kThreads, 0, s>>>(ca, cb, K, rank, eq);
  scatter_kernel<<<kb, kThreads, 0, s>>>(ca, cb, K, rank, eq, sorted);
  if (n > 0) {
    const int chunks = (K + kChunk - 1) / kChunk;
    int blocks = (n + 8 * kThreads - 1) / (8 * kThreads);
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    const int per_block = (n + blocks - 1) / blocks;
    count_kernel<<<dim3(blocks, chunks), kThreads, 0, s>>>(
        sorted, K, pa, pb, vm, n, per_block, hist);
  }
  gather_kernel<<<kb, kThreads, 0, s>>>(ca, K, rank, hist, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pair_count_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
