"""PageStore: the pluggable page-granular storage seam (DESIGN.md §11).

A copy of ``repro/store/base.py`` (numpy) for the port.

The paper's secondary-memory argument (§1/§6) is that once the dictionary
(grammar + directories + bucket tables) stays in RAM, retrieving a list of
compressed length ``l~`` touches only ``1 + ceil((l~-1)/B)`` *contiguous*
disk blocks of the sequence C.  This module turns that observation into an
API: the compressed stream — and only the stream — lives behind a
:class:`PageStore`, cut into the SAME fixed pages the paged kernels DMA by
(``PagedIndex`` geometry), while everything the paper keeps in RAM
(grammar tables, span directory, (b)-sampling buckets, codec auxiliaries)
stays in RAM.

Two implementations:

* :class:`MemoryPageStore` — today's behavior: the paged stream arrays are
  wrapped zero-copy; ``gather`` is a numpy fancy-index.
* :class:`MmapPageStore` — the stream pages and their pre-gathered phrase
  sums are written to disk at build time and read back through
  ``np.memmap``; the OS page cache plus the :class:`ResidentSet` admission
  cache (``resident.py``) decide what is actually hot.

A store always holds the **dense** re-encoded symbol ids (the exact
``FlatIndex.c`` stream) so one store serves every engine; the metadata
carries the inverse map (``term_values``, ``nt_orig``) so the host
accessors can recover original grammar symbol ids from a page read.
"""

from __future__ import annotations

import numpy as np

from ..core.index import DEFAULT_PAGE, flat_index_arrays
from ..core.repair import RePairResult

_PAGE_BYTES_PER_SYM = 8        # int32 syms + int32 sums


def normalize_page_size(page_size: int | None) -> int:
    """The ONE page-size rounding rule, shared with ``build_paged_index``:
    lane-multiple, minimum one 128-lane row."""
    p = DEFAULT_PAGE if page_size is None else int(page_size)
    return max(128, -(-p // 128) * 128)


def pages_in_spans(lo, hi, page_size: int) -> np.ndarray:
    """Unique page ids covered by the absolute symbol spans ``[lo, hi)``
    (vectorized over many spans; empty spans contribute nothing)."""
    lo = np.asarray(lo, np.int64).reshape(-1)
    hi = np.asarray(hi, np.int64).reshape(-1)
    m = hi > lo
    if not m.any():
        return np.zeros(0, np.int64)
    p0 = lo[m] // page_size
    p1 = (hi[m] - 1) // page_size
    width = int((p1 - p0).max()) + 1
    grid = p0[:, None] + np.arange(width, dtype=np.int64)
    return np.unique(grid[grid <= p1[:, None]])


class PageStore:
    """Base page store: fixed-size pages of the dense compressed stream
    plus the matching pre-gathered phrase sums.

    Subclasses set ``_syms_pg`` / ``_sums_pg`` to any 2-D
    ``(num_pages, page_size)`` int32 array-likes supporting fancy row
    indexing (numpy arrays, ``np.memmap``).  ``meta`` carries what the
    RAM-resident tier needs to interpret page contents:

    * ``starts``   — (L+1,) int64 absolute span directory,
    * ``term_values`` — (T,) int64 dense-terminal value table,
    * ``nt_orig``  — the grammar's original ``num_terminals`` (anchors the
      dense→original rule-id inverse), or ``None`` when the store was
      built from a bare ``FlatIndex``.
    """

    kind = "abstract"

    def __init__(self, syms_pg, sums_pg, page_size: int, n_syms: int,
                 meta: dict):
        self._syms_pg = syms_pg
        self._sums_pg = sums_pg
        self.page_size = int(page_size)
        self.num_pages = int(syms_pg.shape[0])
        self.n_syms = int(n_syms)
        self.meta = dict(meta)
        self.pages_gathered = 0     # lifetime I/O accounting
        # close-while-serving protocol (DESIGN.md §11.6): readers that
        # hold long-lived views of the backing arrays (a ResidentSet
        # pool faulting on demand, hence any StoreResView above it) pin
        # the store; close() while pinned DEFERS teardown until the last
        # pin is released, so an in-flight query on a swapped-out index
        # can never read through a freed mapping / deleted directory
        self._pins = 0
        self._close_pending = False
        self.closed = False

    # -- the one read primitive ------------------------------------------

    def gather(self, pages) -> tuple[np.ndarray, np.ndarray]:
        """Batched page fetch: ``(syms, sums)`` each ``(n, page_size)``
        int32.  ONE call per fault batch — the admission cache guarantees
        at most one gather per scheduler tick (DESIGN.md §11.3)."""
        if self.closed:
            raise RuntimeError("gather on a closed page store")
        pages = np.asarray(pages, np.int64).reshape(-1)
        self.pages_gathered += int(pages.size)
        return (np.asarray(self._syms_pg[pages], np.int32),
                np.asarray(self._sums_pg[pages], np.int32))

    # -- span helpers (the paper's contiguous-block unit) ----------------

    def span_pages(self, lo: int, hi: int) -> np.ndarray:
        """Pages covering the absolute symbol span ``[lo, hi)``."""
        return pages_in_spans([lo], [hi], self.page_size)

    def list_span(self, i: int) -> tuple[int, int]:
        starts = self.meta["starts"]
        return int(starts[i]), int(starts[i + 1])

    def page_accesses(self, i: int) -> int:
        """Pages touched to read list ``i`` end to end — the paper's
        §1/§6 bound instantiated at page granularity: contiguous spans
        cost ``1 + ceil((l~ - 1) / page_size)`` pages (the +1 absorbs
        span/page misalignment)."""
        lo, hi = self.list_span(i)
        return int(self.span_pages(lo, hi).size)

    def to_orig_symbols(self, dense) -> np.ndarray:
        """Dense stream ids back to original grammar symbol ids (exact
        inverse of ``_dense_remap``): ``id < T`` is the terminal with gap
        value ``term_values[id]``; ``id >= T`` is rule ``id - T``."""
        nt = self.meta.get("nt_orig")
        if nt is None:
            raise ValueError(
                "store built without grammar metadata (nt_orig); "
                "construct it via build_page_store(res, ...) to serve "
                "host accessors")
        tv = self.meta["term_values"]
        dense = np.asarray(dense, np.int64)
        T = int(tv.size)
        safe = np.minimum(dense, max(T - 1, 0))
        return np.where(dense < T, tv[safe] if T else 0,
                        nt + dense - T).astype(np.int64)

    # -- lifecycle (close-while-serving) ---------------------------------

    def pin(self) -> None:
        """Register a long-lived reader of the backing arrays."""
        self._pins += 1

    def unpin(self) -> None:
        """Release one pin; a deferred close() fires when the last reader
        is gone."""
        self._pins = max(0, self._pins - 1)
        if self._pins == 0 and self._close_pending and not self.closed:
            self.closed = True
            self._teardown()

    @property
    def pins(self) -> int:
        return self._pins

    def close(self) -> None:
        """Release the store's backing resources.  With readers still
        pinned the close is DEFERRED — recorded, and executed by the last
        ``unpin()`` — so closing a store out from under an in-flight
        query (swap + close) is always safe.  Idempotent."""
        if self.closed:
            return
        if self._pins > 0:
            self._close_pending = True
            return
        self.closed = True
        self._teardown()

    def _teardown(self) -> None:   # subclasses with file handles override
        pass


class StoreResView:
    """A ``RePairResult``-shaped read view whose list symbols come out of
    the page store (through the :class:`ResidentSet` admission cache) —
    the host accessors built on it never touch the in-RAM stream.  The
    grammar, span directory, and per-list scalars stay plain RAM
    attributes, mirroring the paper's RAM/disk split."""

    def __init__(self, res: RePairResult, resident):
        self.grammar = res.grammar
        self.starts = np.asarray(res.starts, np.int64)
        self.first_values = res.first_values
        self.orig_lengths = res.orig_lengths
        self.universe = res.universe
        self._resident = resident
        resident.store.to_orig_symbols([0])   # fail fast if meta-less

    @property
    def num_lists(self) -> int:
        return int(self.starts.size - 1)

    def list_symbols(self, i: int) -> np.ndarray:
        lo, hi = int(self.starts[i]), int(self.starts[i + 1])
        dense, _ = self._resident.read_span(lo, hi)
        return self._resident.store.to_orig_symbols(dense)

    def decode_list(self, i: int) -> np.ndarray:
        gaps = []
        for s in self.list_symbols(i):
            gaps.extend(self.grammar.expand_symbol(int(s)))
        head = int(self.first_values[i])
        if not gaps:
            return np.asarray([head], dtype=np.int64)
        return head + np.concatenate(
            [[0], np.cumsum(np.asarray(gaps, dtype=np.int64))])

    def compressed_length(self, i: int) -> int:
        return int(self.starts[i + 1] - self.starts[i])


def paged_stream_arrays(res: RePairResult, page_size: int):
    """Page the dense stream of ``res`` exactly as ``build_paged_index``
    does (same dense re-encoding, same zero padding) so a store built here
    is bit-identical to the device arrays any engine builds from the same
    ``res``.  Returns ``(syms_pg, sums_pg, meta)`` — all host numpy."""
    fi, statics = flat_index_arrays(res)
    c = np.asarray(fi["c"], np.int32)
    sums = np.asarray(fi["sym_sum"], np.int32)[c]
    N = c.size
    num_pages = max(1, -(-N // page_size))
    pad = num_pages * page_size - N
    syms_pg = np.pad(c, (0, pad)).reshape(num_pages, page_size)
    sums_pg = np.pad(sums, (0, pad)).reshape(num_pages, page_size)
    T = int(statics["num_terminals"])
    meta = dict(starts=np.asarray(res.starts, np.int64),
                term_values=np.asarray(fi["sym_sum"], np.int64)[:T],
                nt_orig=int(res.grammar.num_terminals))
    return syms_pg, sums_pg, meta


def meta_from_parts(starts, term_values, nt_orig) -> dict:
    return dict(starts=np.asarray(starts, np.int64),
                term_values=np.asarray(term_values, np.int64),
                nt_orig=None if nt_orig is None else int(nt_orig))
