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
// lengths and sums plus a few grammar nodes per slot.  On the served
// index (20,000 docs) b_pad is 32,768 and most of a serve launch's output
// is padding; the live slots are few but uneven (most entries hold a few
// elements, a term found in every document 20,000), and each costs a
// search and a descent of up to max_depth levels of dependent loads.
//
// What the design does about it:
// * The work is cut by units of 512 live output slots, not by entries, as
//   the TPU kernel's (Q, b_pad / 128) grid cut it.  A persistent grid
//   (four blocks of 256 threads per SM, no more than the launch's units)
//   hands unit u to block u mod gridDim: every block scans the entries'
//   unit counts itself (one block-wide scan per 256 entries, then a shared
//   list of each entry's units for this block), so no plan is built on the
//   host or in another launch, and the widest entry's 40 units land on 40
//   blocks instead of one.
// * A unit's block reads its entry's window of phrase lengths and sums (at
//   most one page): each thread its own run of at most eight symbols,
//   straight into registers with eight loads in flight, then a block-wide
//   int32 scan of the runs' totals and the running sums into shared
//   memory.
// * Each thread owns two output slots of the unit: a binary search for
//   each slot's symbol in shared memory (the TPU kernel's compare-count
//   returns the same searchsorted-left index) and a positional descent,
//   both slots in lock step, so each dependent step issues the loads of
//   both, and a level's loads (left and right child, then the left
//   child's length and sum) are issued together.  One slot per thread left
//   the serve launches with more units than resident blocks; four
//   lengthened every unit, and choosing per launch cost the plan a second
//   scan: all three measured slower on an H100 80GB HBM3 at 700 W.  A
//   lane leaves on a terminal (the fixed-depth program's fixed point, so
//   the early exit is bit-exact).
// * Why a slot searches and descends rather than each symbol expanding its
//   phrase once: the expansion costs O(output + rule nodes) but serialises
//   a phrase on its thread, and the widest entries are exactly the ones
//   whose few window symbols are long phrases (a list of consecutive
//   documents is runs of one gap, whose rules double in length, so 20,000
//   elements come from a handful of symbols).  Per slot
//   the work is at most log2(page) + 2 * max_depth loads for every slot
//   alike, and the grammar nodes near each phrase's root are shared by
//   neighbouring slots in L1.
// * Padding is a second loop over segments of 16 KB of each row: every
//   block writes its share with 16-byte stores, past each entry's live
//   slots (the TPU kernel's 128-slot `cnt` tile guard).
// * Int32 sums wrap like XLA's int32 adds (done in unsigned arithmetic).

#include <cuda_runtime.h>

namespace {

constexpr int kIntInf = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kSlots = 2;            // output slots per thread in a unit
constexpr int kUnit = kThreads * kSlots;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;            // window loads a thread keeps in flight
constexpr int kTile = 128;           // the TPU kernel's output tile (TILE_B)
constexpr int kPadInt4 = 1024;       // 16-byte stores per padding segment
constexpr int kBlocksPerSm = 4;      // the persistent grid's blocks per SM

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// Slots [0, live) of a row are decoded, the rest are padding: the TPU
// kernel decodes a 128-slot tile only if it starts below the count.
__device__ __forceinline__ int live_slots(int c, int b_pad) {
  return c > 0 ? min(b_pad, (min(c, b_pad) + kTile - 1) / kTile * kTile)
               : 0;
}

// Exclusive block-wide prefix of v over the threads (int32 adds that
// wrap); the block's total in *total.
__device__ int block_exclusive_scan(int v, int* warp_buf, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = wrap_add(inc, t);
  }
  if (lane == 31) warp_buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_buf[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = wrap_add(w, t);
    }
    if (lane < kWarps) warp_buf[lane] = w;
  }
  __syncthreads();
  const int out = wrap_add(warp > 0 ? warp_buf[warp - 1] : 0,
                           wrap_sub(inc, v));
  *total = warp_buf[kWarps - 1];
  __syncthreads();                   // warp_buf is free for the next scan
  return out;
}

struct Tables {
  const int* pages;
  const int* slo;
  const int* nsym;
  const int* base;
  const int* head;
  const int* cnt;
  const int* sym_left;
  const int* sym_right;
  const int* sym_sum;
  const int* sym_len;
  const int* c_syms;                 // (pages, page) flat
  const int* c_sums;
  const int* c_lens;
};

// Unit r of entry q: output slots [r * kUnit, (r + 1) * kUnit) that lie
// below the entry's live slots; thread t owns slots r * kUnit + u *
// kThreads + t, u < kSlots, and searches and descends for all of them at
// once, so each dependent step issues kSlots loads.
__device__ void decode_unit(const Tables& t, int* __restrict__ out, int q,
                            int r, int page, int b_pad, int max_depth,
                            int num_terminals, int* cum_len, int* cum_sum,
                            int* warp_buf) {
  const int lo = min(max(t.slo[q], 0), page);
  const int n = min(max(t.nsym[q], 0), page - lo);
  const long long off = static_cast<long long>(t.pages[q]) * page + lo;
  const int b0 = t.base[q];
  const int h = t.head[q];

  // thread t scans symbols [i0, i1) of the window, kBatch loads of each
  // table in flight: its totals, the block's exclusive scan of them, then
  // its running sums into shared memory (the second pass reads L1)
  const int chunk = (n + kThreads - 1) / kThreads;
  const int i0 = min(threadIdx.x * chunk, n);
  const int i1 = min(i0 + chunk, n);
  int ta = 0, tb = 0, total;
  for (int i = i0; i < i1; i += kBatch) {
    int l[kBatch], v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      l[u] = i + u < i1 ? __ldg(t.c_lens + off + i + u) : 0;
      v[u] = i + u < i1 ? __ldg(t.c_sums + off + i + u) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ta = wrap_add(ta, l[u]);
      tb = wrap_add(tb, v[u]);
    }
  }
  __syncthreads();                   // the window of the previous unit
  ta = block_exclusive_scan(ta, warp_buf, &total);
  tb = wrap_add(block_exclusive_scan(tb, warp_buf, &total), b0);
  for (int i = i0; i < i1; i += kBatch) {
    int l[kBatch], v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      l[u] = i + u < i1 ? __ldg(t.c_lens + off + i + u) : 0;
      v[u] = i + u < i1 ? __ldg(t.c_sums + off + i + u) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i + u >= i1) break;
      ta = wrap_add(ta, l[u]);
      tb = wrap_add(tb, v[u]);
      cum_len[i + u] = ta;
      cum_sum[i + u] = tb;
    }
  }
  __syncthreads();

  const int live = live_slots(t.cnt[q], b_pad);
  const int j0 = r * kUnit + threadIdx.x;
  if (j0 >= live) return;
  const int elems = wrap_add(h, n > 0 ? cum_len[n - 1] : 0);
  // slot u decodes if it is a gap element (want >= 1) below the count;
  // want < 1 is the head, and slots past the count are INT_INF
  int want[kSlots], at[kSlots];
  bool gap[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = j0 + u * kThreads;
    want[u] = j - h + 1;             // 1-based gap element
    gap[u] = j < live && j < elems && want[u] >= 1;
    at[u] = 0;
  }
  // first symbol whose running count reaches want (searchsorted-left):
  // a branch-free lower bound, the same number of steps for every slot
  if (n > 0) {
    for (int len = n; len > 1; len -= len >> 1) {
      const int half = len >> 1;
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        at[u] += cum_len[at[u] + half - 1] < want[u] ? half : 0;
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) at[u] += cum_len[at[u]] < want[u];
  }
  int s[kSlots], w[kSlots], sym[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int a = at[u];
    s[u] = a > 0 ? cum_sum[a - 1] : b0;
    w[u] = want[u] - (a > 0 ? cum_len[a - 1] : 0);
    sym[u] = gap[u] ? __ldg(t.c_syms + off + a) : 0;
  }
  // the positional descent, kSlots lanes of it at once: both children,
  // then the left child's length and sum, each level
  for (int d = 0; d < max_depth; ++d) {
    int left[kSlots], right[kSlots], ll[kSlots], ls[kSlots];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const bool rule = sym[u] >= num_terminals;
      any |= rule;
      left[u] = rule ? __ldg(t.sym_left + sym[u]) : 0;
      right[u] = rule ? __ldg(t.sym_right + sym[u]) : 0;
    }
    if (!any) break;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const bool rule = sym[u] >= num_terminals;
      ll[u] = rule ? __ldg(t.sym_len + left[u]) : 0;
      ls[u] = rule ? __ldg(t.sym_sum + left[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (sym[u] < num_terminals) continue;
      if (w[u] <= ll[u]) {
        sym[u] = left[u];
      } else {
        s[u] = wrap_add(s[u], ls[u]);
        w[u] -= ll[u];
        sym[u] = right[u];
      }
    }
  }
  int* row = out + static_cast<long long>(q) * b_pad;
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = j0 + u * kThreads;
    if (j >= live) break;
    row[j] = gap[u] ? wrap_add(s[u], __ldg(t.sym_sum + sym[u]))
             : j < elems ? b0 : kIntInf;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
page_score_kernel(Tables t, int* __restrict__ out, int nq, int page,
                  int b_pad, int max_depth, int num_terminals) {
  extern __shared__ int smem[];
  int* cum_len = smem;               // [page] running element counts
  int* cum_sum = smem + page;        // [page] running absolute values
  __shared__ int warp_buf[kWarps];
  __shared__ int4 s_rec[kThreads];   // (entry, first unit, units) of this
  __shared__ int s_nrec;             // block, one record per entry

  // 1. decode: unit u (entries in order, units of an entry in order) is
  // this block's if u mod gridDim.x == blockIdx.x
  const long long G = gridDim.x;
  long long running = 0;
  for (int e0 = 0; e0 < nq; e0 += kThreads) {
    const int q = e0 + threadIdx.x;
    const int units =
        q < nq ? (live_slots(t.cnt[q], b_pad) + kUnit - 1) / kUnit : 0;
    if (threadIdx.x == 0) s_nrec = 0;
    int chunk_units;
    const long long lo =
        running + block_exclusive_scan(units, warp_buf, &chunk_units);
    const long long first =
        lo + ((static_cast<long long>(blockIdx.x) - lo) % G + G) % G;
    if (first < lo + units)
      s_rec[atomicAdd(&s_nrec, 1)] = make_int4(
          q, static_cast<int>(first - lo),
          static_cast<int>((lo + units - 1 - first) / G) + 1, 0);
    __syncthreads();
    const int nrec = s_nrec;
    for (int k = 0; k < nrec; ++k) {
      const int4 rec = s_rec[k];
      for (int i = 0; i < rec.z; ++i)
        decode_unit(t, out, rec.x, rec.y + i * static_cast<int>(G), page,
                    b_pad, max_depth, num_terminals, cum_len, cum_sum,
                    warp_buf);
    }
    running += chunk_units;
    __syncthreads();                 // s_rec and s_nrec are reused
  }

  // 2. padding: segments of kPadInt4 16-byte stores of each row
  const int w4 = b_pad / 4;
  const int segs = (w4 + kPadInt4 - 1) / kPadInt4;
  const int4 inf4 = make_int4(kIntInf, kIntInf, kIntInf, kIntInf);
  for (long long p = blockIdx.x; p < static_cast<long long>(nq) * segs;
       p += G) {
    const int q = static_cast<int>(p / segs);
    const int s = static_cast<int>(p - static_cast<long long>(q) * segs);
    int4* row = reinterpret_cast<int4*>(out + static_cast<long long>(q) *
                                                  b_pad);
    const int c1 = min((s + 1) * kPadInt4, w4);
    for (int c = max(s * kPadInt4, live_slots(t.cnt[q], b_pad) / 4) +
                 threadIdx.x;
         c < c1; c += kThreads)
      row[c] = inf4;
  }
}

}  // namespace

// sms: the card's streaming multiprocessors, which size the grid.
extern "C" int page_score_launch(
    const int* pages, const int* slo, const int* nsym, const int* base,
    const int* head, const int* cnt, const int* sym_left,
    const int* sym_right, const int* sym_sum, const int* sym_len,
    const int* c_syms_pg, const int* c_sums_pg, const int* clens_pg,
    int* out, int q, int page, int b_pad, int max_depth, int num_terminals,
    int sms, void* stream) {
  if (q <= 0) return 0;
  // as many blocks as fit the card at once, but no more than the launch's
  // most units (every row all live)
  const long long units =
      static_cast<long long>(q) * ((b_pad + kUnit - 1) / kUnit);
  const long long resident = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(units < resident ? units : resident);
  const size_t smem = 2 * static_cast<size_t>(page) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        page_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Tables t{pages,    slo,       nsym,    base,      head,
                 cnt,      sym_left,  sym_right, sym_sum, sym_len,
                 c_syms_pg, c_sums_pg, clens_pg};
  page_score_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      t, out, q, page, b_pad, max_depth, num_terminals);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* page_score_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
