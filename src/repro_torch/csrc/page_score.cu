// Kernel K2 of the PyTorch/CUDA port: block-max page-entry decode, the
// device half of ranked retrieval's ScoreRound.  Each entry of the score
// directory names one (list, stream page) slice — its symbol window
// [slo, slo + nsym) inside the page, the running base value before it, a
// head flag, and its element count — and the kernel expands it into one
// INT_INF-padded row of absolute doc ids.
//
// Replaces the TPU kernel
//   src/repro/kernels/page_score/page_score.py:122 page_decode_pallas
// and must equal it and src/repro/engine/jnp_backend.py:555
// decode_pages_batch bit for bit.
//
// What bounds it on Hopper: bytes, mostly the output.  A row is b_pad
// slots wide (the directory's largest entry rounded up to a power of two)
// and every slot is written, while an entry reads at most one page of
// lengths and sums plus a few grammar nodes per slot.
//
// What the design does about it:
// * One block per entry.  The block loads the entry's window of phrase
//   lengths and sums (at most one page: 16 KB at 2048 symbols) into shared
//   memory with coalesced loads and takes a block-wide int32 inclusive
//   scan of both, so each slot finds its owning symbol by a binary search
//   in shared memory.  The TPU kernel's (TILE_B, PAGE) compare-count and
//   one-hot gathers existed because VMEM gathers do not vectorize; the
//   binary search returns the same searchsorted-left index.
// * Threads stride over the row's slots, so the writes of a warp are
//   contiguous.  Slots past the count and the TPU kernel's dead 128-slot
//   tiles (the `cnt` guard) are written as INT_INF without any decode.
// * The positional descent reads grammar nodes through the read-only
//   cache; a lane leaves it when it reaches a terminal (the fixed-depth
//   program's fixed point, so the early exit is bit-exact).
// * Int32 sums wrap like XLA's int32 adds (done in unsigned arithmetic).

#include <cuda_runtime.h>

namespace {

constexpr int kIntInf = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // the TPU kernel's output tile (TILE_B)

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// Exclusive block-wide prefix of (a, b) over the threads, in place.
__device__ void block_exclusive_scan2(int& a, int& b, int* warp_a,
                                      int* warp_b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ia = a, ib = b;
  for (int o = 1; o < 32; o <<= 1) {
    const int ta = __shfl_up_sync(0xffffffffu, ia, o);
    const int tb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia = wrap_add(ia, ta);
      ib = wrap_add(ib, tb);
    }
  }
  if (lane == 31) {
    warp_a[warp] = ia;
    warp_b[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = lane < kWarps ? warp_a[lane] : 0;
    int wb = lane < kWarps ? warp_b[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int ta = __shfl_up_sync(0xffffffffu, wa, o);
      const int tb = __shfl_up_sync(0xffffffffu, wb, o);
      if (lane >= o) {
        wa = wrap_add(wa, ta);
        wb = wrap_add(wb, tb);
      }
    }
    if (lane < kWarps) {
      warp_a[lane] = wa;
      warp_b[lane] = wb;
    }
  }
  __syncthreads();
  const int pa = warp > 0 ? warp_a[warp - 1] : 0;
  const int pb = warp > 0 ? warp_b[warp - 1] : 0;
  a = wrap_add(pa, wrap_sub(ia, a));
  b = wrap_add(pb, wrap_sub(ib, b));
}

__global__ void __launch_bounds__(kThreads)
page_score_kernel(const int* __restrict__ pages, const int* __restrict__ slo,
                  const int* __restrict__ nsym, const int* __restrict__ base,
                  const int* __restrict__ head, const int* __restrict__ cnt,
                  const int* __restrict__ sym_left,
                  const int* __restrict__ sym_right,
                  const int* __restrict__ sym_sum,
                  const int* __restrict__ sym_len,
                  const int* __restrict__ c_syms,   // (pages, page) flat
                  const int* __restrict__ c_sums,
                  const int* __restrict__ c_lens,
                  int* __restrict__ out, int page, int b_pad,
                  int max_depth, int num_terminals) {
  extern __shared__ int smem[];
  int* cum_len = smem;           // [page] running element counts
  int* cum_sum = smem + page;    // [page] running absolute values
  __shared__ int warp_a[kWarps], warp_b[kWarps];

  const int q = blockIdx.x;
  int* row = out + static_cast<long long>(q) * b_pad;
  // the TPU kernel decodes a 128-slot tile only if it starts below cnt
  const int c = cnt[q];
  const int live =
      c > 0 ? min(b_pad, ((c + kTile - 1) / kTile) * kTile) : 0;
  for (int j = live + threadIdx.x; j < b_pad; j += kThreads)
    row[j] = kIntInf;
  if (live == 0) return;

  const int lo = min(max(slo[q], 0), page);
  const int n = min(max(nsym[q], 0), page - lo);
  const long long off = static_cast<long long>(pages[q]) * page + lo;
  const int b0 = base[q];
  const int h = head[q];

  // coalesced load of the window, then per-thread chunks of the scan
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cum_len[i] = __ldg(c_lens + off + i);
    cum_sum[i] = __ldg(c_sums + off + i);
  }
  __syncthreads();
  const int chunk = (n + kThreads - 1) / kThreads;
  const int i0 = min(threadIdx.x * chunk, n);
  const int i1 = min(i0 + chunk, n);
  int ta = 0, tb = 0;
  for (int i = i0; i < i1; ++i) {
    ta = wrap_add(ta, cum_len[i]);
    tb = wrap_add(tb, cum_sum[i]);
  }
  block_exclusive_scan2(ta, tb, warp_a, warp_b);
  tb = wrap_add(tb, b0);         // running values start at the base
  for (int i = i0; i < i1; ++i) {
    ta = wrap_add(ta, cum_len[i]);
    tb = wrap_add(tb, cum_sum[i]);
    cum_len[i] = ta;
    cum_sum[i] = tb;
  }
  __syncthreads();

  const int total = wrap_add(h, n > 0 ? cum_len[n - 1] : 0);
  for (int j = threadIdx.x; j < live; j += kThreads) {
    int v = kIntInf;
    if (j < total) {
      const int want = j - h + 1;   // 1-based gap element; < 1 -> the head
      if (want < 1) {
        v = b0;
      } else {
        // first symbol whose running count reaches want (searchsorted-left)
        int a = 0, z = n;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (cum_len[mid] < want) a = mid + 1; else z = mid;
        }
        int s = a > 0 ? cum_sum[a - 1] : b0;
        int w = want - (a > 0 ? cum_len[a - 1] : 0);
        int sym = __ldg(c_syms + off + a);
        for (int d = 0; d < max_depth && sym >= num_terminals; ++d) {
          const int left = __ldg(sym_left + sym);
          const int ll = __ldg(sym_len + left);
          if (w <= ll) {
            sym = left;
          } else {
            s = wrap_add(s, __ldg(sym_sum + left));
            w -= ll;
            sym = __ldg(sym_right + sym);
          }
        }
        v = wrap_add(s, __ldg(sym_sum + sym));
      }
    }
    row[j] = v;
  }
}

}  // namespace

extern "C" int page_score_launch(
    const int* pages, const int* slo, const int* nsym, const int* base,
    const int* head, const int* cnt, const int* sym_left,
    const int* sym_right, const int* sym_sum, const int* sym_len,
    const int* c_syms_pg, const int* c_sums_pg, const int* clens_pg,
    int* out, int q, int page, int b_pad, int max_depth, int num_terminals,
    void* stream) {
  if (q <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(page) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        page_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  page_score_kernel<<<q, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pages, slo, nsym, base, head, cnt, sym_left, sym_right, sym_sum,
      sym_len, c_syms_pg, c_sums_pg, clens_pg, out, page, b_pad, max_depth,
      num_terminals);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* page_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
