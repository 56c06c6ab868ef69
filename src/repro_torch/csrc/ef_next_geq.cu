// Kernel K3 of the PyTorch/CUDA port: Elias-Fano next_geq, one answer per
// (list, x) lane — the smallest element of the list that is >= x, or
// INT_INF — over an EF store whose packed low bits, unary high bits and
// select samples all sit in device memory.
//
// Replaces the TPU kernel
//   src/repro/kernels/ef_next_geq/ef_next_geq.py:131 ef_intersect_pallas
// together with its host router (src/repro/kernels/ef_next_geq/ops.py:41
// route_low_pages, which runs core.ef.ef_probe_state_np), and must equal
// src/repro/core/ef.py ef_next_geq_jnp / ef_next_geq_np bit for bit.
//
// What bounds it on Hopper: memory latency.  A lane is a chain of
// dependent 4-byte loads — directory entries, three bisections over the
// select samples, up to 8 high-bits words per select, then a bisection
// over the bucket's low-bits fields — with a few integer operations per
// load.  The bytes a launch must move are small (the whole store of the
// 20,000-doc corpus in "ef" mode is 1.28 MB and stays in the 50 MB L2);
// the time is the depth of each lane's chain.
//
// What the design does about it:
// * One thread per lane computes the whole next_geq: the masks, the three
//   selects and the low-bits search.  On the TPU the selects ran on the
//   host and the kernel only scanned the lows, page by page through VMEM,
//   with a carry word for fields straddling pages and one-hot masked-sum
//   gathers — all because VMEM held a few pages.  On the card the store is
//   addressable, so a straddling field is just the next word, a gather is
//   one load, and fusing the selects keeps ef_probe_state_np (tens of
//   full-width numpy passes) off the host, where the serve path spends its
//   time.  No router, no lane sort, no padding.
// * Each loop leaves at its fixed point: a bisection whose range closed,
//   a word scan that found its word, a bit scan that found its bit, a
//   bucket search with lo >= hi.  Past that point the fixed-trip reference
//   would not change the values it returns, so the early exit is exact.
// * The bucket search is the reference's bisection itself (same midpoints,
//   same index), not a linear scan.
// * int32 arithmetic wraps as in XLA (done in unsigned), every right shift
//   is logical (uint32_t), and shifts by 32 are guarded: a field at bit
//   offset 0 takes nothing from the next word, and (1 << l) - 1 wraps to
//   0x7FFFFFFF at l = 31 as the reference's int32 shift does.
// * Tables are read through the read-only data cache (__ldg).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntInf = 0x7fffffff;
constexpr int kThreads = 128;
constexpr int kSelPage = 8;          // words per select-sample page
constexpr int kSelBits = kSelPage * 32;
constexpr int kBisect = 32;          // the reference's fixed trip count

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int srl(int x, int s) {      // 0 <= s < 32
  return static_cast<int>(static_cast<uint32_t>(x) >> s);
}
// lax.shift_left on int32: wraps, and gives 0 for shifts of 32 or more
__device__ __forceinline__ int sll(int x, int s) {
  return (s < 0 || s >= 32) ? 0
                            : static_cast<int>(static_cast<uint32_t>(x) << s);
}
// floor division, as jnp's // on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}
// gather with the reference's upper clamp min(i, top) and jnp's wrap of a
// negative index
__device__ __forceinline__ int take(const int* __restrict__ t, int i, int top,
                                    int size) {
  i = min(i, top);
  if (i < 0) i += size;
  return __ldg(t + i);
}

// Bit position, relative to the list's high region, of the k-th one
// (ones) or zero: bisection over the select samples, a SEL_PAGE-word
// popcount scan, an in-word bit scan (src/repro/core/ef.py:366 select).
__device__ __forceinline__ int select_bit(const int* __restrict__ hi_words,
                                          int nw, const int* __restrict__ rank,
                                          int npg, int hp0, int hp1,
                                          int hw_reg, int k, bool ones) {
  const int r0 = take(rank, hp0, npg - 1, npg);
  int lo = hp0;
  int hi = max(wsub(hp1, 1), hp0);
  for (int it = 0; it < kBisect && lo != hi; ++it) {
    const int mid = srl(wadd(wadd(lo, hi), 1), 1);
    const int rm = take(rank, mid, npg - 1, npg);
    const int cnt = ones ? wsub(rm, r0)
                         : wsub(wmul(wsub(mid, hp0), kSelBits), wsub(rm, r0));
    const bool go = cnt <= k;
    lo = go ? mid : lo;
    hi = max(go ? hi : wsub(mid, 1), lo);
  }
  const int rp = take(rank, lo, npg - 1, npg);
  const int base = ones ? wsub(rp, r0)
                        : wsub(wmul(wsub(lo, hp0), kSelBits), wsub(rp, r0));
  const int k_rel = wsub(k, base);
  const int w0 = wmul(lo, kSelPage);
  int cum = 0, word_sel = w0, k_in = k_rel;
  for (int j = 0; j < kSelPage; ++j) {
    const int w = take(hi_words, wadd(w0, j), nw - 1, nw);
    const int c = ones ? __popc(w) : 32 - __popc(w);
    if (wadd(cum, c) > k_rel) {
      word_sel = wadd(w0, j);
      k_in = wsub(k_rel, cum);
      break;
    }
    cum = wadd(cum, c);
  }
  const uint32_t w =
      static_cast<uint32_t>(take(hi_words, word_sel, nw - 1, nw));
  const uint32_t want = ones ? 1u : 0u;
  int cnt = 0, bit = 0;
  for (int b = 0; b < 32; ++b) {
    const bool isb = ((w >> b) & 1u) == want;
    if (isb && cnt == k_in) {
      bit = b;
      break;
    }
    cnt += isb;
  }
  return wadd(wmul(wsub(word_sel, hw_reg), 32), bit);
}

// The l-bit field at int32 bit offset gbit of the packed low bits
// (src/repro/core/ef.py:416 low_read); a field may straddle two words.
__device__ __forceinline__ int low_read(const int* __restrict__ lo_words,
                                        int nlw, int gbit, int l) {
  const int w = min(srl(gbit, 5), nlw - 2);
  const int i0 = w < 0 ? w + nlw : w;
  const int i1 = w + 1 < 0 ? w + 1 + nlw : w + 1;
  const int off = gbit & 31;
  const int lowpart = srl(__ldg(lo_words + i0), off);
  const int hipart = off == 0 ? 0 : sll(__ldg(lo_words + i1), (32 - off) & 31);
  return (lowpart | hipart) & wsub(sll(1, l), 1);
}

__global__ void __launch_bounds__(kThreads)
ef_next_geq_kernel(const int* __restrict__ lids, const int* __restrict__ xs,
                   const int* __restrict__ n_t, const int* __restrict__ l_t,
                   const int* __restrict__ f_t, const int* __restrict__ last_t,
                   const int* __restrict__ low_t,
                   const int* __restrict__ hiw_t,
                   const int* __restrict__ lo_words,
                   const int* __restrict__ hi_words,
                   const int* __restrict__ rank, int* __restrict__ out, int q,
                   int nlw, int nw, int npg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q) return;
  const int lid = lids[i];
  const int x = xs[i];
  const int n = __ldg(n_t + lid);
  const int first = __ldg(f_t + lid);
  const int last = __ldg(last_t + lid);
  // the masks: an empty list, x at or before the head, x past the tail
  if (n == 0 || x > last) {
    out[i] = kIntInf;
    return;
  }
  if (x <= first) {
    out[i] = first;
    return;
  }
  const int l = __ldg(l_t + lid);
  const int x_eff = min(max(x, first), max(last, 0));
  const int hx = srl(x_eff, l);
  const int xlo = x_eff & wsub(sll(1, l), 1);
  const int hw0 = __ldg(hiw_t + lid);
  const int hp0 = floor_div(hw0, kSelPage);
  const int hp1 = floor_div(__ldg(hiw_t + lid + 1), kSelPage);
  const int i1 = wsub(select_bit(hi_words, nw, rank, npg, hp0, hp1, hw0, hx,
                                 false), hx);
  const int pos0 = select_bit(hi_words, nw, rank, npg, hp0, hp1, hw0,
                              max(wsub(hx, 1), 0), false);
  const int i0 = hx == 0 ? 0 : wsub(pos0, wsub(hx, 1));
  const int i1m = min(max(i1, 0), max(wsub(n, 1), 0));
  const int hi1 = wsub(select_bit(hi_words, nw, rank, npg, hp0, hp1, hw0, i1m,
                                  true), i1m);
  const int gb0 = wmul(__ldg(low_t + lid), 32);
  // the bucket [i0, i1): first element whose low part is >= xlo
  int lo_b = i0, hi_b = i1;
  for (int it = 0; it < kBisect && lo_b < hi_b; ++it) {
    const int mid = srl(wadd(lo_b, hi_b), 1);
    if (low_read(lo_words, nlw, wadd(gb0, wmul(mid, l)), l) >= xlo) {
      hi_b = mid;
    } else {
      lo_b = wadd(mid, 1);
    }
  }
  const bool found = lo_b < i1;
  const int e = found ? lo_b : i1m;
  const int lowe = low_read(lo_words, nlw, wadd(gb0, wmul(e, l)), l);
  out[i] = sll(found ? hx : hi1, l) | lowe;
}

}  // namespace

extern "C" int ef_next_geq_launch(
    const int* lids, const int* xs, const int* n, const int* lbits,
    const int* firsts, const int* lasts, const int* lo_word,
    const int* hi_word, const int* lo_words, const int* hi_words,
    const int* rank_pg, int* out, int q, int nlw, int nw, int npg,
    void* stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kThreads - 1) / kThreads;
  ef_next_geq_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lids, xs, n, lbits, firsts, lasts, lo_word, hi_word, lo_words,
      hi_words, rank_pg, out, q, nlw, nw, npg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ef_next_geq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
