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
// What bounds it on Hopper: the depth of a lane's chain of dependent
// loads, times the latency, once per wave of resident threads, and the
// instructions each warp issues on the way.  The bytes a launch must move
// are few (the lane arrays, and a store that stays in the 50 MB L2: 1.28
// MB for the 20,000-doc corpus in "ef" mode).  The first design (the
// reference's three selects one after the other, each a bisection over
// the select samples, a word-by-word popcount scan and a 32-step bit
// scan) had a chain of some fifty loads a lane, and spilled.
//
// What the design does about it — each step shortens the chain or cuts
// instructions, and none changes an answer:
// * The directory (n, first, last, l, the high and low region offsets) is
//   read in one round of independent loads, before the masks decide.
// * One full select a lane, select0(hx): the reference's bisection over
//   the samples (its midpoints; the count at lo is kept, not loaded
//   again), then the sample page (SEL_PAGE = 8 words; every list's high
//   region starts on a page, so a page is 32-byte aligned) read as two
//   16-byte loads into registers, a three-level search of its words'
//   popcounts and a 5-step in-word select.  An unaligned high-bits array
//   reads the page word by word.
// * The two other selects come from the bits around select0(hx).  The
//   ones just below it are bucket hx, so select0(hx - 1) is the zero
//   below that run (clz of the word, and of the word before it); the one
//   just above it is select1(i1), the first element past the bucket,
//   needed only when the bucket misses (ffs).  Where a run leaves the two
//   words, a full select answers, as the reference's.
// * The bucket [i0, i1) and the element after it usually span at most
//   three low-bits words: four independent loads bring them into
//   registers and the reference's bisection runs there (its same
//   midpoints).  A wider bucket runs it over device memory.  l = 0 reads
//   nothing: every low part is 0.
// * Loops whose trip count depends on the data stay rolled; the
//   bisection loads a sample without the reference's clamp where the
//   list's sample range lies inside the table (always, for a store this
//   package builds), and with it elsewhere.  Ten blocks of 128 threads a
//   SM (at most 48 registers, no spills) keep more lanes in flight than
//   the 56 registers the compiler picks on its own.
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

// Position of the k-th (0-based) set bit of w; k < popcount(w).
__device__ __forceinline__ int select_in_word(uint32_t w, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const uint32_t low = w & ((1u << s) - 1u);
    const int c = __popc(low);
    const bool up = k >= c;
    k = up ? k - c : k;
    w = up ? w >> s : low;
    pos = up ? pos + s : pos;
  }
  return pos;
}

// One select-sample page of the high bits in registers, with the zero
// counts of its words that a select in it needs.
struct Page {
  int p;           // the page
  int zb;          // zeros of the region before it
  uint32_t w[kSelPage];
  int z0, z2, z4, z6, z01, z45, z03, z47;
};

// Word j of the page (0 outside 0..7), by selects: no local memory.
__device__ __forceinline__ uint32_t word_at(const Page& s, int j) {
  const uint32_t a = (j & 1) ? s.w[1] : s.w[0], b = (j & 1) ? s.w[3] : s.w[2];
  const uint32_t c = (j & 1) ? s.w[5] : s.w[4], d = (j & 1) ? s.w[7] : s.w[6];
  const uint32_t w = (j & 4) ? ((j & 2) ? d : c) : ((j & 2) ? b : a);
  return (j < 0 || j >= kSelPage) ? 0u : w;
}

// The k-th one (ones) or zero of page s, 0-based from the page start:
// its word j and bit, or j = -1 where the page holds fewer (the
// reference's word scan then reports word w0, bit 0).  A three-level
// search of the page's counts, then the in-word select.
__device__ __forceinline__ void in_page(const Page& s, int k, bool ones,
                                        int& j, int& bit, uint32_t& word) {
  const int tot = ones ? 256 - (s.z03 + s.z47) : s.z03 + s.z47;
  if (k < 0 || k >= tot) {
    j = -1;
    bit = 0;
    word = 0;
    return;
  }
  const int q = ones ? 128 - s.z03 : s.z03;
  const bool h4 = k >= q;
  k -= h4 ? q : 0;
  const int pz = h4 ? s.z45 : s.z01;
  const int pc = ones ? 64 - pz : pz;
  const bool h2 = k >= pc;
  k -= h2 ? pc : 0;
  const int wz = h4 ? (h2 ? s.z6 : s.z4) : (h2 ? s.z2 : s.z0);
  const int wc = ones ? 32 - wz : wz;
  const bool h1 = k >= wc;
  k -= h1 ? wc : 0;
  j = (h4 ? 4 : 0) + (h2 ? 2 : 0) + (h1 ? 1 : 0);
  const uint32_t a = h1 ? s.w[1] : s.w[0], b = h1 ? s.w[3] : s.w[2];
  const uint32_t c = h1 ? s.w[5] : s.w[4], d = h1 ? s.w[7] : s.w[6];
  word = h4 ? (h2 ? d : c) : (h2 ? b : a);
  bit = select_in_word(ones ? word : ~word, k);
}

// The reference's bisection over the select samples for the largest page
// lo in [lo, hi] whose count before it is <= k (the count at lo, `base`,
// is <= k); kClamp takes each sample with the reference's clamped gather.
template <bool kClamp>
__device__ __forceinline__ void bisect(const int* __restrict__ rank, int npg,
                                       int hp0, int r0, int k, bool ones,
                                       int& lo, int& hi, int& base) {
#pragma unroll 1
  for (int it = 0; it < kBisect && lo != hi; ++it) {
    const int mid = srl(wadd(wadd(lo, hi), 1), 1);
    const int rm = wsub(kClamp ? take(rank, mid, npg - 1, npg)
                               : __ldg(rank + mid), r0);
    const int cnt = ones ? rm : wsub(wmul(wsub(mid, hp0), kSelBits), rm);
    const bool go = cnt <= k;
    lo = go ? mid : lo;
    base = go ? cnt : base;
    hi = max(go ? hi : wsub(mid, 1), lo);
  }
}

// The reference's select (src/repro/core/ef.py:366): the k-th one (ones)
// or zero of a list's high region.  Its bisection over the samples, the
// page read into `s` as two 16-byte loads, then the select in the page.
__device__ __forceinline__ void select_page(
    const int* __restrict__ hi_words, int nw, bool vec,
    const int* __restrict__ rank, int npg, int hp0, int hp1, int k,
    bool ones, Page& s, int& j, int& bit, uint32_t& word) {
  const int r0 = take(rank, hp0, npg - 1, npg);
  int lo = hp0;
  int hi = max(wsub(hp1, 1), hp0);
  int base = 0;                        // the count before page lo
  if (lo >= 0 && hi <= npg - 1) {      // every midpoint lies in the table
    bisect<false>(rank, npg, hp0, r0, k, ones, lo, hi, base);
  } else {
    bisect<true>(rank, npg, hp0, r0, k, ones, lo, hi, base);
  }
  s.p = lo;
  s.zb = ones ? wsub(wmul(wsub(lo, hp0), kSelBits), base) : base;
  const int w0 = wmul(lo, kSelPage);
  if (vec && w0 >= 0 && w0 <= nw - kSelPage) {
    const int4* h4 = reinterpret_cast<const int4*>(hi_words + w0);
    const int4 u = __ldg(h4), v = __ldg(h4 + 1);
    s.w[0] = u.x; s.w[1] = u.y; s.w[2] = u.z; s.w[3] = u.w;
    s.w[4] = v.x; s.w[5] = v.y; s.w[6] = v.z; s.w[7] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kSelPage; ++q)
      s.w[q] = static_cast<uint32_t>(take(hi_words, wadd(w0, q), nw - 1, nw));
  }
  int z[kSelPage];
#pragma unroll
  for (int q = 0; q < kSelPage; ++q) z[q] = 32 - __popc(s.w[q]);
  s.z0 = z[0]; s.z2 = z[2]; s.z4 = z[4]; s.z6 = z[6];
  s.z01 = z[0] + z[1];
  s.z45 = z[4] + z[5];
  s.z03 = s.z01 + z[2] + z[3];
  s.z47 = s.z45 + z[6] + z[7];
  in_page(s, wsub(k, base), ones, j, bit, word);
}

// Bit position of word j, bit b of page p relative to the region start
// hw_reg — (word_sel - hw_reg) * 32 + bit, with the reference's word w0
// and bit 0 where its select ran past the page.
__device__ __forceinline__ int position(int p, int j, int b, int hw_reg) {
  const int word = wadd(wmul(p, kSelPage), j < 0 ? 0 : j);
  return wadd(wmul(wsub(word, hw_reg), 32), j < 0 ? 0 : b);
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

// The same field from four low-bits words held in registers, the first
// being word a0; the caller guarantees the field's words lie in them.
__device__ __forceinline__ int low_reg(const int (&lw)[4], int a0, int gbit,
                                       int l) {
  const int i = srl(gbit, 5) - a0;
  const int off = gbit & 31;
  const int w0 = i == 0 ? lw[0] : i == 1 ? lw[1] : lw[2];
  const int w1 = i == 0 ? lw[1] : i == 1 ? lw[2] : lw[3];
  const int lowpart = srl(w0, off);
  const int hipart = off == 0 ? 0 : sll(w1, (32 - off) & 31);
  return (lowpart | hipart) & wsub(sll(1, l), 1);
}

__global__ void __launch_bounds__(kThreads, 10)
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
  // the whole directory entry in one round of loads
  const int n = __ldg(n_t + lid);
  const int first = __ldg(f_t + lid);
  const int last = __ldg(last_t + lid);
  const int l = __ldg(l_t + lid);
  const int hw0 = __ldg(hiw_t + lid);
  const int hw1 = __ldg(hiw_t + lid + 1);
  const int lw0 = __ldg(low_t + lid);
  // the masks: an empty list, x at or before the head, x past the tail
  if (n == 0 || x > last) {
    out[i] = kIntInf;
    return;
  }
  if (x <= first) {
    out[i] = first;
    return;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(hi_words) & 15) == 0;
  const int x_eff = min(max(x, first), max(last, 0));
  const int hx = srl(x_eff, l);
  const int xlo = x_eff & wsub(sll(1, l), 1);
  const int hp0 = floor_div(hw0, kSelPage);
  const int hp1 = floor_div(hw1, kSelPage);

  // select0(hx), the zero that closes bucket hx; the ones run just below
  // it is the bucket, so select0(hx - 1) is the zero below that run
  Page s;
  int j1, b1;
  uint32_t w1;
  select_page(hi_words, nw, vec, rank, npg, hp0, hp1, hx, false, s, j1, b1,
              w1);
  const int pos1 = position(s.p, j1, b1, hw0);
  const int i1 = wsub(pos1, hx);
  int i0 = 0;
  if (hx != 0) {
    // ones directly below bit b1, into the word before where they fill
    // the rest of this one
    const int run = b1 == 0 ? 0 : __clz(~(w1 << (32 - b1)));
    const uint32_t prev = word_at(s, j1 - 1);
    const int run2 = __clz(~prev);
    if (j1 >= 0 && run < b1) {
      i0 = wsub(i1, run);
    } else if (j1 > 0 && run2 < 32) {
      i0 = wsub(i1, b1 + run2);
    } else {
      int j0, b0;
      uint32_t w0;
      Page t;
      select_page(hi_words, nw, vec, rank, npg, hp0, hp1, wsub(hx, 1), false,
                  t, j0, b0, w0);
      i0 = wsub(position(t.p, j0, b0, hw0), wsub(hx, 1));
    }
  }
  const int i1m = min(max(i1, 0), max(wsub(n, 1), 0));

  // the bucket [i0, i1): first element whose low part is >= xlo
  int lo_b = i0, lowe = 0;
  bool found;
  if (l == 0) {                        // every low part is 0, and so is xlo
    found = i0 < i1;
  } else {
    const int gb0 = wmul(lw0, 32);
    const int ga = wadd(gb0, wmul(i0, l));
    const int gz = wadd(gb0, wmul(i1m, l));
    const int a0 = srl(ga, 5);
    if (ga >= 0 && gz >= ga && i0 <= i1m && i1 <= wadd(i1m, 1) &&
        srl(gz, 5) - a0 <= 2 && srl(gz, 5) + 1 <= nlw - 1) {
      int lw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lw[j] = __ldg(lo_words + min(a0 + j, nlw - 1));
      int hi_b = i1;
#pragma unroll 1
      for (int it = 0; it < kBisect && lo_b < hi_b; ++it) {
        const int mid = srl(wadd(lo_b, hi_b), 1);
        if (low_reg(lw, a0, wadd(gb0, wmul(mid, l)), l) >= xlo) {
          hi_b = mid;
        } else {
          lo_b = wadd(mid, 1);
        }
      }
      found = lo_b < i1;
      lowe = low_reg(lw, a0, wadd(gb0, wmul(found ? lo_b : i1m, l)), l);
    } else {
      int hi_b = i1;
#pragma unroll 1
      for (int it = 0; it < kBisect && lo_b < hi_b; ++it) {
        const int mid = srl(wadd(lo_b, hi_b), 1);
        if (low_read(lo_words, nlw, wadd(gb0, wmul(mid, l)), l) >= xlo) {
          hi_b = mid;
        } else {
          lo_b = wadd(mid, 1);
        }
      }
      found = lo_b < i1;
      lowe = low_read(lo_words, nlw, wadd(gb0, wmul(found ? lo_b : i1m, l)),
                      l);
    }
  }
  if (found) {
    out[i] = sll(hx, l) | lowe;
    return;
  }
  // a miss: the answer is element i1m, whose high part is select1(i1m)
  // less i1m — the first one above select0(hx) when i1m = i1
  const uint32_t above = b1 >= 31 ? 0u : w1 >> (b1 + 1);
  const uint32_t next = word_at(s, j1 + 1);
  int pos2;
  if (j1 >= 0 && i1m == i1 && above != 0) {
    pos2 = wadd(pos1, __ffs(above));
  } else if (j1 >= 0 && j1 < kSelPage - 1 && i1m == i1 && next != 0) {
    pos2 = wadd(pos1, 31 - b1 + __ffs(next));
  } else {
    int j2, b2;
    uint32_t w2;
    select_page(hi_words, nw, vec, rank, npg, hp0, hp1, i1m, true, s, j2, b2,
                w2);
    pos2 = position(s.p, j2, b2, hw0);
  }
  out[i] = sll(wsub(pos2, i1m), l) | lowe;
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
