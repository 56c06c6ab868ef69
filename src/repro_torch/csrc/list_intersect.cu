// Kernel K1 of the PyTorch/CUDA port: batched next_geq over the paged
// Re-Pair stream, one answer per (list, x) lane — the smallest element of
// the list that is >= x, or INT_INF.
//
// Replaces the TPU kernel
//   src/repro/kernels/list_intersect/list_intersect.py:158
//   paged_intersect_pallas
// and must equal src/repro/engine/jnp_backend.py:98 _next_geq_one_paged
// bit for bit, starting from the host router's start state (pos0, s0).
//
// What bounds it on Hopper: memory latency, and bytes behind it.  A lane
// does almost no arithmetic: a chain of dependent 4-byte loads — phrase
// sums along the stream while it skips, then one grammar node per
// descent step.  Total traffic is small; time is the depth of each chain.
//
// What the design does about it:
// * One thread per lane, and the whole paged stream is addressed directly
//   in device memory.  The TPU kernel's K-page grid state machine existed
//   because one VMEM block could hold only a few pages, and its one-hot
//   masked-sum gathers because VMEM gathers do not vectorize; on the card
//   a gather is one load, so both go.
// * Lanes arrive sorted by anchor page (host router), so the threads of a
//   warp walk neighbouring stream positions and share cache lines.
// * Each lane leaves a loop at its fixed point: once a skip step does not
//   take (or the descent reaches a terminal) the fixed-trip program would
//   not change its state again, so the early exit is bit-exact.  Lanes
//   the final selects override (x > last, answered by the start state,
//   run past the span) skip the work whose value would be discarded.
// * Grammar tables are read through the read-only data cache (__ldg);
//   they are O(rules), small enough to stay resident in L2.
// * Int32 sums wrap like XLA's int32 adds (done in unsigned arithmetic).
//
// Out of core, the same kernel reads the stream from the bounded pool of
// the admission cache (ResidentSet) instead of the whole paged stream —
// the route of src/repro/kernels/list_intersect/ops.py:244
// next_geq_resident, where the TPU kernel's page BlockSpec reads the
// pool row of each tile page from `tile_slots`.  Here it is one template
// argument: kResident = true reads position `pos` as
//     slot = max(slot_of_page[pos / page], 0)
//     pool[slot * page + pos % page]
// (integer division: the page is a multiple of 128, not a power of two),
// and kResident = false compiles to the fully resident kernel unchanged.
// A page outside the launch's working set has slot -1, clamped to row 0,
// whose contents are arbitrary.  No lane's answer depends on such a read:
// * a lane with x > last, or whose start state already answers
//   (s0 >= x), returns before its first stream read (the second check is
//   resident-only; on a real stream the first skip step would not take,
//   so the fully resident kernel gives the same answer);
// * any other lane (s0 < x, pos0 < end, x <= last) reads sums at
//   pos0 .. pos0 + max_scan - 1 and at most one symbol at
//   pos <= pos0 + max_scan, all before `end`: pages
//   [pos0 / page, min((pos0 + max_scan) / page, end / page)], exactly the
//   window the host router faults in (probe_working_set).

#include <cuda_runtime.h>

namespace {

constexpr int kIntInf = 0x7fffffff;
constexpr int kThreads = 128;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

// Position `pos` of the stream: the paged stream itself, or its pool row
// through the slot table.
template <bool kResident>
__device__ __forceinline__ int stream_at(const int* __restrict__ stream,
                                         const int* __restrict__ slot_of_page,
                                         int page, int num_pages, int pos) {
  if constexpr (kResident) {
    const int pg = pos / page;
    const int slot = max(__ldg(slot_of_page + min(pg, num_pages - 1)), 0);
    return __ldg(stream + slot * page + (pos - pg * page));
  } else {
    return __ldg(stream + pos);
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
list_intersect_kernel(const int* __restrict__ lids,
                      const int* __restrict__ xs,
                      const int* __restrict__ pos0,
                      const int* __restrict__ s0,
                      const int* __restrict__ starts,
                      const int* __restrict__ lasts,
                      const int* __restrict__ sym_left,
                      const int* __restrict__ sym_right,
                      const int* __restrict__ sym_sum,
                      const int* __restrict__ c_syms,   // paged or pool
                      const int* __restrict__ c_sums,   // paged or pool
                      const int* __restrict__ slot_of_page,
                      int* __restrict__ out, int q, int max_scan,
                      int max_depth, int num_terminals, int page,
                      int num_pages) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q) return;
  const int lid = lids[i];
  const int x = xs[i];
  if (x > __ldg(lasts + lid)) {          // no element >= x in the list
    out[i] = kIntInf;
    return;
  }
  const int end = __ldg(starts + lid + 1);
  int pos = pos0[i];
  int s = s0[i];
  if (kResident && s >= x) {             // answered by the start state,
    out[i] = s;                          // before any stream read
    return;
  }

  // phrase-sum skipping: at most max_scan steps while s + sum < x
  for (int k = 0; k < max_scan && pos < end; ++k) {
    const int ps = stream_at<kResident>(c_sums, slot_of_page, page,
                                        num_pages, pos);
    const int t = wrap_add(s, ps);
    if (!(t < x)) break;
    s = t;
    ++pos;
  }
  if (s >= x) {                          // the previous element answers
    out[i] = s;
    return;
  }
  if (pos >= end) {                      // ran off the list span
    out[i] = kIntInf;
    return;
  }

  // fixed-depth descent inside the halting phrase
  int sym = stream_at<kResident>(c_syms, slot_of_page, page, num_pages, pos);
  for (int d = 0; d < max_depth && sym >= num_terminals; ++d) {
    const int left = __ldg(sym_left + sym);
    const int ls = __ldg(sym_sum + left);
    if (wrap_add(s, ls) >= x) {
      sym = left;
    } else {
      s = wrap_add(s, ls);
      sym = __ldg(sym_right + sym);
    }
  }
  out[i] = wrap_add(s, __ldg(sym_sum + sym));
}

}  // namespace

// slot_of_page == nullptr: the fully resident route over the paged
// stream; otherwise c_syms_pg / c_sums_pg are the resident pool's
// (budget, page) rows and slot_of_page its (num_pages,) table.
extern "C" int list_intersect_launch(
    const int* lids, const int* xs, const int* pos0, const int* s0,
    const int* starts, const int* lasts, const int* sym_left,
    const int* sym_right, const int* sym_sum, const int* c_syms_pg,
    const int* c_sums_pg, const int* slot_of_page, int* out, int q,
    int max_scan, int max_depth, int num_terminals, int page, int num_pages,
    void* stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slot_of_page == nullptr) {
    list_intersect_kernel<false><<<blocks, kThreads, 0, st>>>(
        lids, xs, pos0, s0, starts, lasts, sym_left, sym_right, sym_sum,
        c_syms_pg, c_sums_pg, nullptr, out, q, max_scan, max_depth,
        num_terminals, page, num_pages);
  } else {
    list_intersect_kernel<true><<<blocks, kThreads, 0, st>>>(
        lids, xs, pos0, s0, starts, lasts, sym_left, sym_right, sym_sum,
        c_syms_pg, c_sums_pg, slot_of_page, out, q, max_scan, max_depth,
        num_terminals, page, num_pages);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* list_intersect_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
