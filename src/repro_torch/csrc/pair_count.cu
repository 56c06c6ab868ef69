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
// (left, right, validity) and 8 per candidate and writes 4 per candidate:
// at the cuda builder's round 1 (K 4,096, N 954,112) that is 11.5 MB, 3.4
// us at the 3.35 TB/s of an H100 SXM (the H100 80GB HBM3 the port is
// measured on, at 700 W).  At that size fixed costs — a table set up per
// block, chains of dependent loads, the atomics that merge the blocks —
// weigh more than the stream.
//
// What the design does about it:
// * One launch, no sort, no K x K pass.  Each block builds an open-
//   addressing hash table of its chunk of candidate keys (a << 32 | b, at
//   most 4,096 keys) in shared memory: 2^bits slots, at least four times
//   the keys, linear probing, so a probe reads about 1.2 slots on a hit and
//   1.4 on a miss (most stream slots miss a capped table), and the longest
//   probe of a warp stays short.  A slot holds the chunk-local index of the
//   copy of its key that claimed it first (atomicCAS); that copy's counter
//   is the key's bin in this block.  Keys (8 B), counters (4 B) and slots
//   (16 B per key) take 112 KB at 4,096 keys.
// * One block of 1,024 threads per SM: the SM builds its table once and
//   flushes it once (two blocks of 512 threads per SM built and flushed it
//   twice, and measured slower).
// * Each thread keeps its loads in flight: eight candidate keys at once,
//   two 16-byte groups of pa, pb and vm (a scalar path for tails and
//   unaligned operands).  A lane's four slots of a group probe the table in
//   lock step: four slot reads, then four key reads, per step.
// * Each slot that hits adds 1 to its bin with a shared atomic.  Combining
//   equal hits first, across a warp (__match_any_sync) or within a lane,
//   measured no faster on round 1's Zipf stream: too few collisions to pay
//   for the match.
// * Every candidate adds the count of its key's bin to its own output
//   entry with one integer atomic, only where the count is non-zero.  The
//   blocks' bins are their own, and every copy of a key finds the same
//   bin, so each duplicate gets the full count, in any order.  The wrapper
//   hands over the output zeroed, so the launch needs no last-block pass.
// * A table longer than one chunk is cut into chunks on the grid's y axis,
//   each counted against the whole stream; a key with copies in two chunks
//   is counted in each, so every candidate reads a full count.
// * The grid is one block per SM over the stream (the wrapper's
//   count_plan), at least 4,096 slots per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kEmpty = -1;            // a free hash slot
constexpr int kBatch = 8;             // loads a thread keeps in flight

__device__ __forceinline__ long long pair_key(int a, int b) {
  return static_cast<long long>(a) * 4294967296LL +
         static_cast<long long>(static_cast<unsigned>(b));
}

// Fibonacci hashing of the key folded to 64 bits: the top `bits` bits.
// kernels/pair_count/ops.py pair_slot is the same function.
__device__ __forceinline__ unsigned slot_of(long long key, int bits) {
  unsigned long long x = static_cast<unsigned long long>(key);
  x ^= x >> 32;
  x *= 0x9E3779B97F4A7C15ull;
  return static_cast<unsigned>(x >> (64 - bits));
}

// The chunk-local index of the copy of `key` that holds its slot, or -1 if
// the chunk lacks it.
__device__ __forceinline__ int find(const long long* s_key,
                                    const int* s_slot, long long key,
                                    int bits) {
  const unsigned mask = (1u << bits) - 1;
  for (unsigned h = slot_of(key, bits);; h = (h + 1) & mask) {
    const int cur = s_slot[h];
    if (cur == kEmpty || s_key[cur] == key) return cur;
  }
}

// Four pair slots of one lane (a 16-byte group of each operand): their
// probes run in lock step, so each step issues four slot reads, then four
// key reads; each slot that hits adds 1 to its key's bin.
__device__ __forceinline__ void count4(int4 a, int4 b, int4 v,
                                       const long long* s_key,
                                       const int* s_slot, int* s_cnt,
                                       int bits) {
  const int av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  const int vv[4] = {v.x, v.y, v.z, v.w};
  const unsigned mask = (1u << bits) - 1;
  long long key[4];
  unsigned h[4];
  int hit[4];
  bool open[4], any = false;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    open[u] = vv[u] != 0 && av[u] >= 0;
    any |= open[u];
    key[u] = pair_key(av[u], bv[u]);
    h[u] = slot_of(key[u], bits);
    hit[u] = kEmpty;
  }
  while (any) {
    int cur[4];
    long long got[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = open[u] ? s_slot[h[u]] : kEmpty;
#pragma unroll
    for (int u = 0; u < 4; ++u) got[u] = cur[u] != kEmpty ? s_key[cur[u]] : -1;
    any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!open[u]) continue;
      if (cur[u] == kEmpty || got[u] == key[u]) {
        hit[u] = cur[u];
        open[u] = false;
      } else {
        h[u] = (h[u] + 1) & mask;
        any = true;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (hit[u] != kEmpty) atomicAdd(s_cnt + hit[u], 1);
}

// Block (x, y) counts its share of the stream against candidates
// [y * chunk, (y + 1) * chunk).
__global__ void __launch_bounds__(kThreads, 1)
pair_count_kernel(const int* __restrict__ ca, const int* __restrict__ cb,
                  const int* __restrict__ pa, const int* __restrict__ pb,
                  const int* __restrict__ vm, int* __restrict__ out, int K,
                  int n, int chunk, int bits, bool vec) {
  extern __shared__ long long smem[];
  long long* s_key = smem;                                  // [chunk]
  int* s_cnt = reinterpret_cast<int*>(s_key + chunk);       // [chunk]
  int* s_slot = s_cnt + chunk;                              // [2^bits]

  const int c0 = blockIdx.y * chunk;
  const int m = min(chunk, K - c0);
  for (int j0 = threadIdx.x; j0 < m; j0 += kBatch * kThreads) {
    int a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      a[u] = j < m ? ca[c0 + j] : 0;
      b[u] = j < m ? cb[c0 + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < m) {
        s_key[j] = pair_key(a[u], b[u]);
        s_cnt[j] = 0;
      }
    }
  }
  for (int h = threadIdx.x; h < (1 << bits); h += kThreads)
    s_slot[h] = kEmpty;
  __syncthreads();

  // the table: a key's slot holds the copy that claimed it first (a key is
  // negative exactly where its candidate is a -1 sentinel)
  const unsigned mask = (1u << bits) - 1;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const long long key = s_key[j];
    if (key < 0) continue;
    for (unsigned h = slot_of(key, bits);; h = (h + 1) & mask) {
      const int cur = atomicCAS(s_slot + h, kEmpty, j);
      if (cur == kEmpty || s_key[cur] == key) break;
    }
  }
  __syncthreads();

  // the stream: 16-byte loads where aligned, two groups of four slots per
  // lane in flight
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * (kThreads / 32);
  const int n4 = vec ? n / 4 : 0;
  const int4* pa4 = reinterpret_cast<const int4*>(pa);
  const int4* pb4 = reinterpret_cast<const int4*>(pb);
  const int4* vm4 = reinterpret_cast<const int4*>(vm);
  for (int g0 = warp * 32; g0 < n4; g0 += 2 * warps * 32) {
    int4 a[2], b[2], v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = g0 + u * warps * 32 + lane;
      a[u] = b[u] = v[u] = make_int4(0, 0, 0, 0);
      if (g < n4) {
        a[u] = __ldg(pa4 + g);
        b[u] = __ldg(pb4 + g);
        v[u] = __ldg(vm4 + g);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      count4(a[u], b[u], v[u], s_key, s_slot, s_cnt, bits);
  }
  for (int i = 4 * n4 + warp * 32 + lane; i < n; i += warps * 32)
    count4(make_int4(__ldg(pa + i), 0, 0, 0), make_int4(__ldg(pb + i), 0, 0, 0),
           make_int4(__ldg(vm + i), 0, 0, 0), s_key, s_slot, s_cnt, bits);
  __syncthreads();

  // every candidate adds its key's count to its own entry
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const long long key = s_key[j];
    if (key < 0) continue;
    const int c = s_cnt[find(s_key, s_slot, key, bits)];
    if (c) atomicAdd(out + c0 + j, c);
  }
}

}  // namespace

// out: K ints, zero on entry.  chunk, bits and blocks come from
// kernels/pair_count/ops.py count_plan.
extern "C" int pair_count_launch(const int* ca, const int* cb, const int* pa,
                                 const int* pb, const int* vm, int* out,
                                 int K, int n,
                                 int chunk, int bits, int blocks,
                                 void* stream) {
  if (K <= 0) return 0;
  const size_t smem = static_cast<size_t>(chunk) * 12 +
                      (static_cast<size_t>(1) << bits) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(pa) |
                     reinterpret_cast<uintptr_t>(pb) |
                     reinterpret_cast<uintptr_t>(vm)) & 15) == 0;
  const dim3 grid(blocks, (K + chunk - 1) / chunk);
  pair_count_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      ca, cb, pa, pb, vm, out, K, n, chunk, bits, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pair_count_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
