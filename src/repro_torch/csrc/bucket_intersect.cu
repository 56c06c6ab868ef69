// Kernel K7 of the PyTorch/CUDA port: domain-bucketed intersection,
//
//   out[r, i] = a[r, i]   if a[r, i] != INT_INF and a[r, i] == b[r, j]
//                         for some j,
//               INT_INF   otherwise,
//
// for two (NB, CAP) int32 matrices of aligned domain buckets padded with
// INT_INF.  The output keeps a's positions, so a bucket-sorted row stays
// sorted.  Exact on any rows: unsorted, with duplicates, with INT_INF
// anywhere.
//
// Replaces the TPU kernel
//   src/repro/kernels/bucket_intersect/bucket_intersect.py:34
//   bucket_intersect_pallas (body _bucket_intersect_kernel, :26),
// and must equal kernels/bucket_intersect/ops.py bucket_intersect_plain
// exactly.
//
// What bounds it on Hopper: bytes.  Three int32 per slot (a, b read, out
// written): at 40,192 rows x 128 that is 62 MB, about 0.018 ms at
// 3.35 TB/s, while the CAP x CAP compares of a full row (6.6e8 in all)
// take 0.010 ms at the scalar rate.
//
// What the design does about it:
// * The TPU built a (TILE_B, CAP, CAP) compare in VMEM.  Here block (r, y)
//   owns elements [y * 128, (y + 1) * 128) of row r of a, one per thread,
//   and stages row r of b in shared memory, 1,024 values at a time, so a
//   row of any CAP fits.  Every thread reads the same staged value at each
//   step (a broadcast, free of bank conflicts) and keeps its hit flag in a
//   register; each of a, b and out is touched once in device memory.
// * A thread stops comparing once it has a hit (or holds INT_INF) but
//   still stages its share of b, so every block reaches each barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // elements of a per block
constexpr int kStage = 1024;               // values of b staged at a time
constexpr int kInf = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
bucket_intersect_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        int* __restrict__ out, int cap) {
  __shared__ int s_b[kStage];
  const size_t row = static_cast<size_t>(blockIdx.x) * cap;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const int x = i < cap ? a[row + i] : kInf;
  bool hit = false;
  for (int j0 = 0; j0 < cap; j0 += kStage) {
    const int m = min(kStage, cap - j0);
    __syncthreads();                       // the last stage is read
    for (int j = threadIdx.x; j < m; j += kThreads) s_b[j] = b[row + j0 + j];
    __syncthreads();
    if (!hit && x != kInf)
      for (int j = 0; j < m; ++j)
        if (s_b[j] == x) {
          hit = true;
          break;
        }
  }
  if (i < cap) out[row + i] = hit ? x : kInf;
}

}  // namespace

extern "C" int bucket_intersect_launch(const int* a, const int* b, int* out,
                                       int nb, int cap, void* stream) {
  if (nb <= 0 || cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nb, (cap + kThreads - 1) / kThreads);
  bucket_intersect_kernel<<<grid, kThreads, 0, s>>>(a, b, out, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bucket_intersect_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
