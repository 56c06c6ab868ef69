"""The backend-pluggable query engine API.

One interface, three interchangeable backends:

* :class:`~repro_torch.engine.host.HostEngine`   — the paper's host
  cursor structures (``CompressedList`` / ``SampledList`` /
  ``LookupList``);
* :class:`~repro_torch.engine.TorchEngine`       — plain PyTorch
  fixed-trip-count programs on a device (the reference for the kernels);
* :class:`~repro_torch.engine.CudaEngine`        — the hand-written CUDA
  kernels ``list_intersect`` (every probe) and ``page_score`` (every
  ranked page decode).

Every operation takes/returns **numpy** at the boundary so callers
(server, launcher, smoke run) are backend-agnostic; sentinel for "no
element" is ``INT_INF`` (int32 max).

The four operations:

* ``next_geq_batch(list_ids, xs)`` — smallest element >= x per query;
* ``member_batch(list_ids, xs)``   — boolean membership per query;
* ``intersect_pairs(pairs)``       — batched 2-term conjunctive queries;
* ``intersect_multi(idxs)``        — one k-term conjunctive query,
  pairwise svs from shortest to longest by *uncompressed* length (§3.3 —
  Re-Pair compressed lengths are non-monotonic).

``dispatch_round(list_ids, xs, algo)`` is the serving runtime's entry
point: one merged probe round — the concatenated ProbeRound workloads of
every in-flight query — deduplicated, memoized, and routed to
``next_geq_batch``/``next_geq_bys_batch``; the device engines pad it to a
power-of-two bucket.

The JAX package's per-list codec tier and out-of-core page store are not
part of this package yet: an engine accepts only ``codec`` None/"repair"
and ``store`` None (and the matching environment defaults) and raises
``NotImplementedError`` on anything else.
"""

from __future__ import annotations

import abc
import os
from typing import Sequence

import numpy as np

from ..core.cache import LRUCache
from ..core.index import (DEFAULT_PAGE, INT_INF, ScoreIndex,
                          accumulate_scores, build_score_index)
from ..core.repair import RePairResult

#: entry bound of the per-engine decoded-list LRU (env override
#: ``REPRO_DECODE_CACHE``; 0 disables caching)
DECODE_CACHE_SIZE = int(os.environ.get("REPRO_DECODE_CACHE", "512"))

#: entry bound of the per-engine probe memo — repeat ``(list, x)`` probes
#: across ticks skip device dispatch entirely.  Env override
#: ``REPRO_PROBE_MEMO``; 0 disables memoization.
PROBE_MEMO_SIZE = int(os.environ.get("REPRO_PROBE_MEMO", "4096"))


def _env_flag(name: str, default: bool = True) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


#: cross-query lane dedup in merged rounds; env override
#: ``REPRO_DEDUP=0`` dispatches every lane
DEDUP_ENABLED = _env_flag("REPRO_DEDUP", True)


def _require_repair_only(codec, store) -> None:
    """Refuse the codec tier and the page store (and their environment
    defaults ``REPRO_CODEC`` / ``REPRO_STORE``), which this package does
    not implement yet — never ignore them silently."""
    mode = codec if codec is not None else \
        os.environ.get("REPRO_CODEC", "repair")
    if mode not in (None, "", "repair"):
        raise NotImplementedError(
            f"codec {mode!r}: only the Re-Pair codec is ported")
    kind = store if store is not None else os.environ.get("REPRO_STORE", "")
    if str(kind).strip().lower() not in ("", "none", "off", "0"):
        raise NotImplementedError(
            f"page store {kind!r}: the out-of-core tier is not ported")


class Engine(abc.ABC):
    """Backend-pluggable query engine over one Re-Pair compressed index."""

    name: str = "abstract"

    #: index-version token in every decode-cache key — the same keying the
    #: serving scheduler's caches use.  ``QueryServer`` stamps it at each
    #: hot-swap; bumping it orphans the old entries, so the LRU evicts
    #: them as new decodes land.
    index_version: int = 0

    #: the codec tier and the page store are not ported: always None (the
    #: planner and the scheduler read these attributes)
    tier = None
    resident = None
    store = None

    def __init__(self, res: RePairResult, codec: str | None = None,
                 store: str | None = None):
        _require_repair_only(codec, store)
        self.res = res
        self.lengths = np.asarray(res.orig_lengths, dtype=np.int64)
        self._decoded = LRUCache(DECODE_CACHE_SIZE)
        self._score_index: ScoreIndex | None = None
        #: probe dispatch telemetry, surfaced by the scheduler
        self.codec_dispatches = {"repair": 0}
        #: cross-query lane dedup toggle — resolved from ``REPRO_DEDUP``
        #: at construction; tests flip it per engine
        self.dedup = DEDUP_ENABLED
        #: bounded probe memo keyed ``(index_version, memo_epoch, algo,
        #: list_id, x)``.  ``swap_index`` builds a FRESH engine per swap,
        #: so the memo is flushed on every hot swap.
        self._probe_memo = LRUCache(PROBE_MEMO_SIZE)
        self.memo_epoch = 0
        #: cumulative merged-round lane accounting; the scheduler
        #: snapshots deltas around each dispatch
        self.lane_stats = {"real_lanes": 0, "unique_lanes": 0,
                           "pad_lanes": 0, "dispatched_lanes": 0,
                           "memo_hits": 0, "memo_misses": 0}
        #: True while inside a merged-round dispatch — scopes the device
        #: engines' pad-lane accounting to the round path (point APIs
        #: like ``member_batch`` pad too but aren't merged-round work)
        self._in_round = False

    # -- point operations ---------------------------------------------------

    @abc.abstractmethod
    def _next_geq_repair(self, list_ids: np.ndarray,
                         xs: np.ndarray) -> np.ndarray:
        """(Q,) int32 values over the Re-Pair structures; INT_INF where
        no element >= x exists.  The backend-specific probe primitive."""

    def next_geq_batch(self, list_ids: np.ndarray,
                       xs: np.ndarray) -> np.ndarray:
        """(Q,) int32 values; INT_INF where no element >= x exists."""
        return np.asarray(self._next_geq_repair(list_ids, xs))

    def member_batch(self, list_ids: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Boolean membership per lane: ``next_geq == x``."""
        lids = np.asarray(list_ids).ravel()
        xq = np.asarray(xs).ravel()
        return np.asarray(self.next_geq_batch(lids, xq)) == xq

    def next_geq_bys_batch(self, list_ids: np.ndarray,
                           xs: np.ndarray) -> np.ndarray:
        """Batched Baeza-Yates-style binary-search next_geq [BY04]; same
        contract as ``next_geq_batch``."""
        return np.asarray(self._next_geq_repair_bys(list_ids, xs))

    def _next_geq_repair_bys(self, list_ids: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """[BY04] probe: the base implementation bisects the DECODED list
        (the classic uncompressed baseline); device engines override it
        with a positional bisection of the compressed stream's phrase-sum
        prefix table (``torch_backend.next_geq_bys_batch``)."""
        lids = np.asarray(list_ids)
        xq = np.asarray(xs, np.int64)
        out = np.full(lids.shape, int(INT_INF), dtype=np.int64)
        for li in np.unique(lids):
            arr = self.decode_list(int(li))
            m = lids == li
            pos = np.searchsorted(arr, xq[m])
            hit = pos < arr.size
            out[m] = np.where(hit, arr[np.minimum(pos, arr.size - 1)],
                              int(INT_INF))
        return out.astype(np.int32)

    # -- merged probe rounds -------------------------------------------------

    def dispatch_round(self, list_ids: np.ndarray, xs: np.ndarray,
                       algo: str = "svs") -> np.ndarray:
        """One (possibly cross-query merged) probe round: route the flat
        ``(list_ids, xs)`` workload of a
        :class:`~repro_torch.query.steps.ProbeRound` to the matching
        primitive — ``"svs"`` → ``next_geq_batch``, ``"bys"`` →
        ``next_geq_bys_batch``.  Both are elementwise in the (list, probe)
        pairs, so concatenating the rounds of many queries into one
        dispatch returns bit-identical values per lane.

        **Hot-path dedup**: duplicate ``(list_id, x)`` lanes — different
        queries probing the same hot term at the same frontier — collapse
        to one representative via ``np.unique``'s inverse map; results
        scatter back to every requesting lane, bit-identical by
        construction.  Surviving unique lanes then consult the bounded
        probe memo; only memo misses reach the backend.  A round fully
        served by the memo skips dispatch entirely."""
        lids = np.asarray(list_ids, np.int32).ravel()
        xq = np.asarray(xs, np.int32).ravel()
        n = lids.size
        if n == 0:
            return np.empty(0, dtype=np.int32)
        st = self.lane_stats
        st["real_lanes"] += n
        inv = None
        if self.dedup and n > 1:
            # (lid, x) -> one int64 key; bijective because list ids are
            # non-negative int32 and x's 32 bits are masked in whole
            key = ((lids.astype(np.int64) << 32)
                   | (xq.astype(np.int64) & 0xFFFFFFFF))
            _, uidx, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
            if uidx.size == n:
                inv = None           # nothing collapsed — skip the scatter
            else:
                lids, xq = lids[uidx], xq[uidx]
        st["unique_lanes"] += lids.size
        memo = self._probe_memo
        if memo.maxsize > 0:
            ver, ep = self.index_version, self.memo_epoch
            out = np.empty(lids.size, np.int32)
            lt, xt = lids.tolist(), xq.tolist()
            miss = []
            for j, (li, x) in enumerate(zip(lt, xt)):
                v = memo.get((ver, ep, algo, li, x))
                if v is None:
                    miss.append(j)
                else:
                    out[j] = v
            st["memo_hits"] += lids.size - len(miss)
            st["memo_misses"] += len(miss)
            if miss:
                mi = np.asarray(miss, np.int64)
                vals = self._dispatch_lanes(lids[mi], xq[mi], algo)
                out[mi] = vals
                for j, v in zip(miss, vals.tolist()):
                    memo.put((ver, ep, algo, lt[j], xt[j]), int(v))
        else:
            out = self._dispatch_lanes(lids, xq, algo)
        return out if inv is None else out[inv]

    def _dispatch_lanes(self, lids: np.ndarray, xq: np.ndarray,
                        algo: str) -> np.ndarray:
        """The post-dedup/post-memo slice of a merged round."""
        self.lane_stats["dispatched_lanes"] += lids.size
        self._in_round = True
        try:
            self.codec_dispatches["repair"] += 1
            return np.asarray(self._dispatch_algo(lids, xq, algo))
        finally:
            self._in_round = False

    def _dispatch_algo(self, lids: np.ndarray, xq: np.ndarray,
                       algo: str) -> np.ndarray:
        """One sub-round through the algorithm's primitive (host tier:
        unpadded; the device override pads to the pow2 bucket first)."""
        if algo == "bys":
            return np.asarray(self._next_geq_repair_bys(lids, xq))
        return np.asarray(self._next_geq_repair(lids, xq))

    # -- whole-list decode ---------------------------------------------------

    def decode_list(self, i: int) -> np.ndarray:
        """Full expansion of one list to sorted int64 doc ids (cached —
        the boolean executor's merge/union/complement operands).  The
        cache is a bounded LRU keyed on ``(index_version, i)``; the
        cached array is returned by reference and frozen: an accidental
        in-place mutation by a caller raises instead of silently
        corrupting every later query that touches the list."""
        i = int(i)
        key = (self.index_version, i)
        out = self._decoded.get(key)
        if out is None:
            out = self._decode_list(i)
            out.flags.writeable = False
            self._decoded.put(key, out)
        return out

    def _decode_list(self, i: int) -> np.ndarray:
        return self.res.decode_list(i)

    # -- ranked scoring ------------------------------------------------------

    @property
    def score_index(self) -> ScoreIndex:
        """The engine's BM25 tables + block-max page directory, built
        lazily on the first ranked query.  Page entries are cut at THIS
        engine's stream-page boundaries (``_score_page_size``) so a page
        decode touches exactly the pages the probe kernels read."""
        if self._score_index is None:
            self._score_index = build_score_index(
                self.res, page_size=self._score_page_size())
        return self._score_index

    def set_score_index(self, si: ScoreIndex) -> None:
        """Share one prebuilt scoring tier across engines over the same
        index.  The page geometry must match — entries address this
        engine's pages."""
        if int(si.page_size) != int(self._score_page_size()):
            raise ValueError(
                f"score index page_size {si.page_size} != engine page "
                f"size {self._score_page_size()}")
        self._score_index = si

    def _score_page_size(self) -> int:
        """Page size of the score directory; device engines cut it at
        their stream pages.  Pruning resolution follows the page size the
        engine is built with (``page_size=128`` prunes finer)."""
        return DEFAULT_PAGE

    def page_elem_bucket(self) -> int:
        """Static width of a decoded page-entry row: the directory's max
        element count rounded to a power of two."""
        m = max(1, int(self.score_index.max_page_elems))
        return max(8, 1 << (m - 1).bit_length())

    def decode_page_batch(self, entries: np.ndarray) -> np.ndarray:
        """Materialize block-max page entries: (Q,) entry ids ->
        (Q, page_elem_bucket) int32 doc ids, INT_INF past each entry's
        count.  Host reference: slice the cached whole-list decode (the
        per-entry ``elem_lo``/``count`` columns exist for exactly this)."""
        si = self.score_index
        e = np.asarray(entries, np.int64).ravel()
        out = np.full((e.size, self.page_elem_bucket()), int(INT_INF),
                      np.int32)
        for q, ei in enumerate(e.tolist()):
            cnt = int(si.pg_count[ei])
            lo = int(si.pg_elem_lo[ei])
            docs = self.decode_list(int(si.pg_list[ei]))
            out[q, :cnt] = docs[lo:lo + cnt]
        return out

    def dispatch_score_round(self, entries: np.ndarray) -> np.ndarray:
        """One (possibly cross-query merged) ScoreRound: decode the flat
        page-entry lanes of every in-flight ranked query.  Elementwise in
        the entry lanes, so merged dispatches return bit-identical rows;
        device engines pad to the same power-of-two buckets as
        ``dispatch_round``.  Duplicate entry lanes dedup exactly like
        probe lanes: decode the unique set, scatter rows back via the
        inverse map."""
        e = np.asarray(entries, np.int32).ravel()
        n = e.size
        if n == 0:
            return np.empty((0, self.page_elem_bucket()), np.int32)
        st = self.lane_stats
        st["real_lanes"] += n
        inv = None
        if self.dedup and n > 1:
            ue, inv = np.unique(e, return_inverse=True)
            if ue.size == n:
                inv = None
            else:
                e = ue.astype(np.int32)
        st["unique_lanes"] += e.size
        st["dispatched_lanes"] += e.size
        self._in_round = True
        try:
            rows = self._dispatch_score_unique(e)
        finally:
            self._in_round = False
        return rows if inv is None else rows[inv]

    def _dispatch_score_unique(self, entries: np.ndarray) -> np.ndarray:
        """The post-dedup slice of a merged ScoreRound (host tier:
        unpadded; the device override pads to the pow2 bucket)."""
        return self.decode_page_batch(entries)

    def score_batch(self, doc_ids: np.ndarray, terms) -> np.ndarray:
        """Exact BM25 scores of ``doc_ids`` for the term bag ``terms``:
        one merged membership round (all K terms × all D docs in a single
        ``next_geq_batch``) feeding the shared fixed-order float32
        reduction — bit-identical on every backend and to the oracle."""
        si = self.score_index
        docs = np.asarray(doc_ids, np.int64).ravel()
        ts = np.asarray(sorted({int(t) for t in terms
                                if 0 <= int(t) < self.lengths.size}),
                        np.int64)
        if docs.size == 0 or ts.size == 0:
            return np.zeros(docs.size, np.float32)
        lids = np.repeat(ts, docs.size).astype(np.int32)
        xs = np.tile(docs, ts.size).astype(np.int32)
        member = (np.asarray(self.next_geq_batch(lids, xs), np.int64)
                  .reshape(ts.size, docs.size) == docs)
        return accumulate_scores(si, ts, member, docs)

    # -- conjunctive queries ------------------------------------------------

    @abc.abstractmethod
    def intersect_pairs(self, pairs: Sequence[tuple[int, int]]
                        ) -> list[np.ndarray]:
        """Batched (term AND term); each result is a sorted int64 id array."""

    @abc.abstractmethod
    def intersect_multi(self, idxs: Sequence[int]) -> np.ndarray:
        """One k-term AND query; sorted int64 id array."""

    def intersect_multi_meld(self, idxs: Sequence[int]) -> np.ndarray:
        """One k-term AND by **adaptive melding** (Barbay–Kenyon style):
        all k cursors chase a common frontier — one batched ``next_geq``
        round advances every list to the current candidate, the maximum
        answer becomes the next candidate, agreement emits an element.
        Backend-generic: implemented purely over ``next_geq_batch``."""
        idxs = [int(i) for i in idxs]
        if not idxs:
            return np.empty(0, dtype=np.int64)
        if len(idxs) == 1:
            return self.decode_list(idxs[0]).copy()  # never alias the cache
        lids = np.asarray(idxs, dtype=np.int32)
        inf = int(INT_INF)
        out: list[int] = []
        x = 0
        while True:
            vals = np.asarray(self.next_geq_batch(
                lids, np.full(lids.size, x, dtype=np.int32)), np.int64)
            m = int(vals.max())
            if m >= inf:        # some list is exhausted — no more matches
                break
            if int(vals.min()) == m:
                out.append(m)
                x = m + 1
            else:
                x = m
        return np.asarray(out, dtype=np.int64)

    # -- helpers shared by the backends -------------------------------------

    def order_by_length(self, idxs: Sequence[int]) -> list[int]:
        """Shortest-first by UNCOMPRESSED length, the [BLOL06] svs order the
        paper adopts in §3.3."""
        return sorted(idxs, key=lambda i: int(self.lengths[i]))

    @staticmethod
    def compact(row: np.ndarray) -> np.ndarray:
        """Strip INT_INF sentinels from a padded device row."""
        row = np.asarray(row)
        return row[row != int(INT_INF)].astype(np.int64)
