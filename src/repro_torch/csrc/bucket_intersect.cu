// Kernel K7 of the PyTorch/CUDA port: domain-bucketed intersection,
//
//   out[r, i] = a[r, i]   if a[r, i] != INT_INF and a[r, i] == b[r, j]
//                         for some j,
//               INT_INF   otherwise,
//
// for two (NB, CAP) int32 matrices of aligned domain buckets padded with
// INT_INF.  The output keeps a's positions, so a bucket-sorted row stays
// sorted.  Exact on any rows: unsorted, with duplicates, with INT_INF
// anywhere, with negative values.
//
// Replaces the TPU kernel
//   src/repro/kernels/bucket_intersect/bucket_intersect.py:34
//   bucket_intersect_pallas (body _bucket_intersect_kernel, :26),
// and must equal kernels/bucket_intersect/ops.py bucket_intersect_plain
// exactly.
//
// What bounds it on Hopper: bytes.  Three int32 per slot (a, b read, out
// written): at 40,192 rows x 128 that is 62 MB, 0.0184 ms at 3.35 TB/s;
// membership needs a constant number of operations per slot.
//
// What the design does about it: a row's live values of b go into a hash
// set in shared memory, and each live value of a makes one probe.  The
// TPU built a (TILE_B, CAP, CAP) compare in VMEM; the first design here
// scanned the row of b per element of a, so a miss cost CAP compares and
// a warp waited on its slowest lane.
// * The set is open addressing with linear probing in a power-of-two table
//   of at least twice the values it takes, so a probe ends at an empty
//   slot.  INT_INF marks an empty slot: a b of INT_INF is never entered,
//   and an a of INT_INF never probes (it cannot hit).  An insert is an
//   atomicCAS that ends where the slot was empty or already holds the
//   value, so duplicates cost nothing more.
// * The hash is multiplicative (the top bits of v * 0x9E3779B1): the
//   values of a bucketized row share their high bits, and the product
//   carries the low ones into the top.
// * CAP <= 128 (the bucketized lists): one warp per row, eight rows a
//   block, a 256-slot table per warp, __syncwarp and no block barrier;
//   each lane loads its four slots of a and of b at once, as 16-byte
//   loads when the rows are 16-byte aligned.
// * CAP > 128: one block of 256 threads per row, a table of up to 8,192
//   slots (32 KB).  A row with more than 4,096 slots of b enters b in
//   chunks of 4,096; every chunk probes all of a, the first writes every
//   slot of out and the later ones only their hits (an OR of the hits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCap = 128;            // widest row a warp takes
constexpr int kWarpBits = 8;             // its table: 256 slots
constexpr int kMaxBits = 13;             // a block's table: <= 8,192 slots
constexpr uint32_t kGolden = 0x9E3779B1u;

__device__ __forceinline__ uint32_t home(int v, int bits) {
  return (static_cast<uint32_t>(v) * kGolden) >> (32 - bits);
}

__device__ __forceinline__ void insert(int* tab, int bits, int v) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t s = home(v, bits);; s = (s + 1u) & mask) {
    const int prev = atomicCAS(tab + s, kInf, v);
    if (prev == kInf || prev == v) return;
  }
}

__device__ __forceinline__ bool member(const int* tab, int bits, int v) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t s = home(v, bits);; s = (s + 1u) & mask) {
    const int t = tab[s];
    if (t == v) return true;
    if (t == kInf) return false;
  }
}

// CAP <= 128: warp w of the block owns row blockIdx.x * 8 + w; lane l
// owns slots 4l..4l+3 (kVec) or l, l+32, l+64, l+96.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bucket_intersect_warp(const int* __restrict__ a, const int* __restrict__ b,
                      int* __restrict__ out, int nb, int cap) {
  __shared__ __align__(16) int s_tab[kWarps << kWarpBits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= nb) return;                 // the whole warp leaves together
  int* tab = s_tab + (warp << kWarpBits);
  const size_t base = static_cast<size_t>(row) * cap;
  int av[4], bv[4];
  if (kVec) {
    const bool own = 4 * lane < cap;
    const int4 x = own ? __ldg(reinterpret_cast<const int4*>(a + base) + lane)
                       : make_int4(kInf, kInf, kInf, kInf);
    const int4 y = own ? __ldg(reinterpret_cast<const int4*>(b + base) + lane)
                       : make_int4(kInf, kInf, kInf, kInf);
    av[0] = x.x; av[1] = x.y; av[2] = x.z; av[3] = x.w;
    bv[0] = y.x; bv[1] = y.y; bv[2] = y.z; bv[3] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = lane + 32 * j;
      av[j] = e < cap ? __ldg(a + base + e) : kInf;
      bv[j] = e < cap ? __ldg(b + base + e) : kInf;
    }
  }
  reinterpret_cast<int4*>(tab)[lane] = make_int4(kInf, kInf, kInf, kInf);
  reinterpret_cast<int4*>(tab)[lane + 32] = make_int4(kInf, kInf, kInf, kInf);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (bv[j] != kInf) insert(tab, kWarpBits, bv[j]);
  __syncwarp();
  int ov[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ov[j] = av[j] != kInf && member(tab, kWarpBits, av[j]) ? av[j] : kInf;
  if (kVec) {
    if (4 * lane < cap)
      reinterpret_cast<int4*>(out + base)[lane] =
          make_int4(ov[0], ov[1], ov[2], ov[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = lane + 32 * j;
      if (e < cap) out[base + e] = ov[j];
    }
  }
}

// CAP > 128: block blockIdx.x owns its row; a table of 2^bits slots takes
// b in chunks of 2^(bits - 1).
__global__ void __launch_bounds__(kThreads)
bucket_intersect_block(const int* __restrict__ a, const int* __restrict__ b,
                       int* __restrict__ out, int cap, int bits) {
  extern __shared__ int tab[];
  const int slots = 1 << bits, chunk = slots >> 1;
  const size_t base = static_cast<size_t>(blockIdx.x) * cap;
  for (int c0 = 0; c0 < cap; c0 += chunk) {
    if (c0) __syncthreads();             // the last chunk's probes are done
    for (int s = threadIdx.x; s < slots; s += kThreads) tab[s] = kInf;
    __syncthreads();
    const int m = min(chunk, cap - c0);
    for (int e = threadIdx.x; e < m; e += kThreads) {
      const int v = __ldg(b + base + c0 + e);
      if (v != kInf) insert(tab, bits, v);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cap; e += kThreads) {
      const int v = __ldg(a + base + e);
      const bool hit = v != kInf && member(tab, bits, v);
      if (c0 == 0) {
        out[base + e] = hit ? v : kInf;
      } else if (hit) {
        out[base + e] = v;
      }
    }
  }
}

}  // namespace

extern "C" int bucket_intersect_launch(const int* a, const int* b, int* out,
                                       int nb, int cap, void* stream) {
  if (nb <= 0 || cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap <= kWarpCap) {
    const bool vec = cap % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int blocks = static_cast<int>((static_cast<long long>(nb) +
                                         kWarps - 1) / kWarps);
    if (vec) {
      bucket_intersect_warp<true><<<blocks, kThreads, 0, s>>>(a, b, out, nb,
                                                              cap);
    } else {
      bucket_intersect_warp<false><<<blocks, kThreads, 0, s>>>(a, b, out, nb,
                                                               cap);
    }
  } else {
    int bits = 1;
    while (bits < kMaxBits && (1LL << bits) < 2LL * cap) ++bits;
    bucket_intersect_block<<<nb, kThreads, sizeof(int) << bits, s>>>(
        a, b, out, cap, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bucket_intersect_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
