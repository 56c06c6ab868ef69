"""ResidentSet: the page-level admission cache over a PageStore.

A copy of ``repro/store/resident.py`` (numpy) for the port, except its
device mirror, which is a torch mirror on an explicit device
(:meth:`ResidentSet.device_tables`).

The page router already computes, per merged round, exactly which
stream pages a dispatch will touch.  This class turns that working set
into an admission cache (DESIGN.md §11.2): a bounded pool of hot pages
pinned in host memory (mirrored to the device on demand), an LRU over page
ids, and a ``slot_of_page`` scatter table that lets the fixed-shape
device programs address the pool by *slot* while the router keeps
thinking in *global* page ids.

Contract with the dispatch loop (DESIGN.md §11.3):

* ``ensure(pages)`` is called BETWEEN ticks with the union working set of
  the tick's merged rounds — misses are served by ONE batched
  ``store.gather`` (so device dispatch shapes stay pow2-stable and jit
  entries stay O(log Q); faults never happen inside a traced program);
* the request set is pinned for the duration of the call — LRU eviction
  never evicts a page the current tick needs; if a single tick needs more
  pages than the budget, the pool grows to the next power of two (counted
  in ``pool_grows`` — capacity is a floor for correctness, a budget for
  steady state);
* cache identity follows the engine: ``swap_index`` builds a new engine
  and therefore a new ResidentSet, while in-flight queries keep the old
  engine (and its resident pool) alive through their ``_InFlight`` pin —
  the same ``(index_version, page)`` keying/flush discipline as the
  decode/result LRUs, implemented structurally.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from .base import PageStore

#: Resident-page budget env knob; <= 0 or unset means "everything fits"
#: (the cache degenerates to a one-time full materialization).
RESIDENT_ENV = "REPRO_RESIDENT_PAGES"

_WINDOW = 4096      # bounded hit-rate window (lookups)


def resident_budget(resident_pages, num_pages: int) -> int:
    """Resolve the pool budget: explicit argument wins, else the
    ``REPRO_RESIDENT_PAGES`` env, else fully resident; always clamped to
    ``[1, num_pages]``."""
    if resident_pages is None:
        env = os.environ.get(RESIDENT_ENV, "").strip()
        resident_pages = int(env) if env else 0
    rp = int(resident_pages)
    if rp <= 0:
        return max(1, int(num_pages))
    return max(1, min(rp, int(num_pages)))


class ResidentSet:
    def __init__(self, store: PageStore, budget: int | None = None):
        self.store = store
        # pin the store for this pool's lifetime: a close() racing with
        # in-flight queries (swap_index then close on the old index)
        # defers until the pool is released or garbage-collected —
        # weakref.finalize is exactly-once, so release() and GC compose
        store.pin()
        self._pin = weakref.finalize(self, store.unpin)
        self.budget = resident_budget(budget, store.num_pages)
        P = store.page_size
        self.pool_syms = np.zeros((self.budget, P), np.int32)
        self.pool_sums = np.zeros((self.budget, P), np.int32)
        self.slot_of_page = np.full(store.num_pages, -1, np.int32)
        self._lru: OrderedDict[int, int] = OrderedDict()   # page -> slot
        self._free = list(range(self.budget - 1, -1, -1))
        # telemetry
        self.page_faults = 0
        self.page_evictions = 0
        self.fault_bytes = 0
        self.pool_grows = 0
        self.lookups = 0
        self.hits = 0
        self._window: deque[bool] = deque(maxlen=_WINDOW)
        # overlapped-prefetch telemetry (DESIGN.md §13.3): pages admitted
        # speculatively, how many were later demanded, and the ids still
        # waiting to prove useful (consumed by ``ensure`` on first demand)
        self.prefetched_pages = 0
        self.prefetch_useful = 0
        self.prefetch_bytes = 0
        self._prefetch_outstanding: set[int] = set()
        # lazy device mirror: full upload once, then incremental scatters
        self._dev = None
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._slots_dirty = True

    # -- admission -------------------------------------------------------

    def ensure(self, pages) -> None:
        """Make every page in ``pages`` resident.  The request set is
        pinned (never evicted within this call); all misses are fetched in
        ONE batched ``store.gather``."""
        pages = np.unique(np.asarray(pages, np.int64).reshape(-1))
        pages = pages[(pages >= 0) & (pages < self.store.num_pages)]
        if pages.size == 0:
            return
        slots = self.slot_of_page[pages]
        hit = slots >= 0
        for p in pages[hit]:
            p = int(p)
            self._lru.move_to_end(p)
            if p in self._prefetch_outstanding:
                self._prefetch_outstanding.discard(p)
                self.prefetch_useful += 1
        n_hit = int(hit.sum())
        self.lookups += int(pages.size)
        self.hits += n_hit
        self._window.extend([True] * n_hit +
                            [False] * (int(pages.size) - n_hit))
        missing = pages[~hit]
        if missing.size == 0:
            return
        if pages.size > self.budget:
            self._grow(int(pages.size))
        alloc: list[int] = []
        while len(alloc) < missing.size and self._free:
            alloc.append(self._free.pop())
        if len(alloc) < missing.size:
            pinned = set(int(p) for p in pages)
            for p in list(self._lru):            # oldest first
                if len(alloc) >= missing.size:
                    break
                if p in pinned:
                    continue
                alloc.append(self._lru.pop(p))
                self.slot_of_page[p] = -1
                self.page_evictions += 1
        # budget >= |pages| and every non-pinned LRU entry is evictable,
        # so allocation always succeeds
        new_slots = np.asarray(alloc, np.int64)
        syms, sums = self.store.gather(missing)
        self.pool_syms[new_slots] = syms
        self.pool_sums[new_slots] = sums
        self.slot_of_page[missing] = new_slots.astype(np.int32)
        for p, sl in zip(missing, new_slots):
            self._lru[int(p)] = int(sl)
        self.page_faults += int(missing.size)
        self.fault_bytes += int(missing.size) * self.store.page_size * 8
        self._pending.append((new_slots.copy(), syms, sums))
        self._slots_dirty = True

    def _grow(self, min_pages: int) -> None:
        """One tick needs more pages than the pool holds: grow to the next
        power of two (correctness floor; the budget stays the steady-state
        target for eviction pressure)."""
        new = self.budget
        while new < min_pages:
            new *= 2
        new = min(new, self.store.num_pages)
        P = self.store.page_size
        syms = np.zeros((new, P), np.int32)
        sums = np.zeros((new, P), np.int32)
        syms[:self.budget] = self.pool_syms
        sums[:self.budget] = self.pool_sums
        self._free.extend(range(new - 1, self.budget - 1, -1))
        self.pool_syms, self.pool_sums = syms, sums
        self.budget = new
        self.pool_grows += 1
        self._dev = None            # pool shape changed: full re-upload
        self._pending.clear()
        self._slots_dirty = True

    # -- overlapped prefetch (DESIGN.md §13.3) ---------------------------

    def peek_missing(self, pages, cap: int | None = None) -> np.ndarray:
        """Read-only snapshot of which of ``pages`` are NOT resident —
        the prefetch job the scheduler hands to its background thread.
        Never mutates the pool, never counts toward hit-rate telemetry
        (speculative lookups would poison the demand hit rate)."""
        pages = np.unique(np.asarray(pages, np.int64).reshape(-1))
        pages = pages[(pages >= 0) & (pages < self.store.num_pages)]
        missing = pages[self.slot_of_page[pages] < 0]
        if cap is not None and missing.size > int(cap):
            missing = missing[:int(cap)]
        return missing

    def admit_prefetched(self, pages: np.ndarray, syms: np.ndarray,
                         sums: np.ndarray) -> int:
        """Admit pages whose rows were gathered by the prefetch thread.
        MAIN-THREAD ONLY: the background thread does the (read-only)
        ``store.gather``; every pool mutation happens here, after the
        scheduler joins the thread (DESIGN.md §13.3 thread contract).

        Speculative admission is strictly best-effort: pages that became
        resident since the ``peek_missing`` snapshot are skipped, the
        pool NEVER grows for a prediction, and eviction pressure is
        bounded to the oldest half of the LRU so a bad prediction can't
        flush the demand-proven hot set.  Returns the admitted count."""
        pages = np.asarray(pages, np.int64).reshape(-1)
        still = self.slot_of_page[pages] < 0
        if not still.all():
            pages, syms, sums = pages[still], syms[still], sums[still]
        if pages.size == 0:
            return 0
        max_evict = len(self._lru) // 2
        limit = len(self._free) + max_evict
        if pages.size > limit:
            pages, syms, sums = (pages[:limit], syms[:limit],
                                 sums[:limit])
        if pages.size == 0:
            return 0
        alloc: list[int] = []
        while len(alloc) < pages.size and self._free:
            alloc.append(self._free.pop())
        if len(alloc) < pages.size:
            for p in list(self._lru):            # oldest first
                if len(alloc) >= pages.size:
                    break
                alloc.append(self._lru.pop(p))
                self.slot_of_page[p] = -1
                self.page_evictions += 1
        new_slots = np.asarray(alloc, np.int64)
        self.pool_syms[new_slots] = syms
        self.pool_sums[new_slots] = sums
        self.slot_of_page[pages] = new_slots.astype(np.int32)
        for p, sl in zip(pages, new_slots):
            self._lru[int(p)] = int(sl)
            self._prefetch_outstanding.add(int(p))
        self.prefetched_pages += int(pages.size)
        self.prefetch_bytes += int(pages.size) * self.store.page_size * 8
        self._pending.append((new_slots.copy(), syms, sums))
        self._slots_dirty = True
        return int(pages.size)

    # -- addressing ------------------------------------------------------

    def read_span(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Host read of the absolute symbol span ``[lo, hi)`` through the
        cache (faults the covering pages if needed) — the contiguous-span
        primitive the paper's host accessors consume."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            z = np.zeros(0, np.int32)
            return z, z
        P = self.store.page_size
        p0, p1 = lo // P, (hi - 1) // P
        pages = np.arange(p0, p1 + 1, dtype=np.int64)
        self.ensure(pages)
        slots = self.slot_of_page[pages]
        a, b = lo - p0 * P, hi - p0 * P
        return (self.pool_syms[slots].reshape(-1)[a:b],
                self.pool_sums[slots].reshape(-1)[a:b])

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        """torch mirror of ``(pool_syms, pool_sums, slot_of_page)`` on
        ``device`` (int32).  The first call, and the first after a
        ``_grow``, uploads the whole pool; later calls apply the pending
        fault batches oldest first, one ``index_copy_`` per batch and
        table, plus a slot-table refresh when it changed.  Batches must
        stay apart: a prefetch admission and a later ``ensure`` in the
        same tick can write the same pool row, and one ``index_copy_``
        with a repeated row leaves which write lands undefined on the
        card; within one batch the rows are distinct.  Every copy reads a
        fresh array (``torch.tensor`` copies; the gathered rows are never
        mutated) and is blocking, so a later ``ensure`` that rewrites the
        numpy pool can never race a copy.  MAIN-THREAD ONLY, like every
        pool mutation."""
        dev = torch.device(device)
        if self._dev is None or self._dev["device"] != dev:
            self._dev = dict(device=dev,
                             syms=torch.tensor(self.pool_syms, device=dev),
                             sums=torch.tensor(self.pool_sums, device=dev),
                             slots=torch.tensor(self.slot_of_page,
                                                device=dev))
            self._pending.clear()
            self._slots_dirty = False
        else:
            for slots, syms, sums in self._pending:
                idx = torch.tensor(slots, device=dev)
                for key, rows in (("syms", syms), ("sums", sums)):
                    self._dev[key].index_copy_(
                        0, idx, torch.tensor(rows, device=dev))
            self._pending.clear()
            if self._slots_dirty:
                self._dev["slots"] = torch.tensor(self.slot_of_page,
                                                  device=dev)
                self._slots_dirty = False
        return self._dev["syms"], self._dev["sums"], self._dev["slots"]

    def release(self) -> None:
        """Drop this pool's pin on the store explicitly (idempotent); a
        deferred store close fires here if this was the last reader."""
        self._pin()

    # -- telemetry -------------------------------------------------------

    @property
    def resident_pages(self) -> int:
        return len(self._lru)

    def hit_rate_window(self) -> float:
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    def stats(self) -> dict:
        return dict(kind=self.store.kind,
                    budget=self.budget,
                    num_pages=self.store.num_pages,
                    page_size=self.store.page_size,
                    resident_pages=self.resident_pages,
                    page_faults=self.page_faults,
                    page_evictions=self.page_evictions,
                    fault_bytes=self.fault_bytes,
                    pool_grows=self.pool_grows,
                    lookups=self.lookups,
                    hits=self.hits,
                    hit_rate_window=self.hit_rate_window(),
                    prefetched_pages=self.prefetched_pages,
                    prefetch_useful=self.prefetch_useful,
                    prefetch_bytes=self.prefetch_bytes)
