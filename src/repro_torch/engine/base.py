"""The backend-pluggable query engine API.

One interface, three interchangeable backends:

* :class:`~repro_torch.engine.host.HostEngine`   — the paper's host
  cursor structures (``CompressedList`` / ``SampledList`` /
  ``LookupList``);
* :class:`~repro_torch.engine.TorchEngine`       — plain PyTorch
  fixed-trip-count programs on a device (the reference for the kernels);
* :class:`~repro_torch.engine.CudaEngine`        — the hand-written CUDA
  kernels ``list_intersect`` (every Re-Pair probe), ``ef_next_geq``
  (every Elias-Fano probe) and ``page_score`` (every ranked page
  decode).

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
``next_geq_batch``/``next_geq_bys_batch``; the device engines pad each
sub-round to a power-of-two bucket.

**Codec tier**: constructed with ``codec`` (or under ``REPRO_CODEC``),
the engine carries a per-list codec assignment (Re-Pair / Elias-Fano /
bitmap, ``index/codec_tier.py``).  The probe entry points split each
round's lanes by codec and dispatch every sub-round through that codec's
``next_geq`` path; with no tier (the default) the Re-Pair path runs
alone.  The Re-Pair structures remain the decode ground truth in every
mode, so results are identical across assignments.

**Out-of-core tier** (DESIGN.md §11): constructed with ``store``
(``"memory"`` / ``"mmap"``, or None to honour ``REPRO_STORE``) the
engine serves the compressed stream from a page store through a bounded
admission cache (``resident_pages``, or ``REPRO_RESIDENT_PAGES``), the
:class:`~repro_torch.store.ResidentSet`; the grammar, span directory and
bucket tables stay in memory, as the paper splits them.
"""

from __future__ import annotations

import abc
import os
from typing import Sequence

import numpy as np

from ..core.cache import LRUCache
from ..core.ef import ef_next_geq_np
from ..core.index import (DEFAULT_PAGE, INT_INF, ScoreIndex,
                          accumulate_scores, build_score_index)
from ..core.repair import RePairResult
from ..index.codec_tier import (CODEC_BITMAP, CODEC_NAMES, bitmap_member_np,
                                bitmap_next_geq_np, build_codec_tier)
from ..obs import span
from ..store import (PageStore, ResidentSet, build_page_store,
                     pages_in_spans, resolve_store_kind)

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


class Engine(abc.ABC):
    """Backend-pluggable query engine over one Re-Pair compressed index."""

    name: str = "abstract"

    #: index-version token in every decode-cache key — the same keying the
    #: serving scheduler's caches use.  ``QueryServer`` stamps it at each
    #: hot-swap; bumping it orphans the old entries, so the LRU evicts
    #: them as new decodes land.
    index_version: int = 0

    def __init__(self, res: RePairResult,
                 codec: "str | object | None" = None,
                 store: "str | object | None" = None,
                 resident_pages: int | None = None):
        self.res = res
        self.lengths = np.asarray(res.orig_lengths, dtype=np.int64)
        # out-of-core tier: ``store`` picks the page-store backend (None
        # defers to REPRO_STORE; ""/none disables; a prebuilt PageStore
        # passes through), and ``resident_pages`` bounds the admission
        # cache (None defers to REPRO_RESIDENT_PAGES).  Construction is
        # deferred to ``_init_store`` / the device engines'
        # ``_attach_store``, once the paged geometry exists.
        self.store = None
        self.resident = None
        self._resident_pages = resident_pages
        self._store_kind = resolve_store_kind(store)
        self._decoded = LRUCache(DECODE_CACHE_SIZE)
        self._score_index: ScoreIndex | None = None
        # per-list codec tier: None in pure-repair mode; a prebuilt
        # CodecTier passes through so servers can share one tier
        self.tier = build_codec_tier(res, codec)
        #: bounded, version-keyed LRU for the EF select samples and the
        #: derived device packs — the same ``REPRO_DECODE_CACHE`` bound
        #: and ``index_version`` keying as the decode LRU, so a hot swap
        #: orphans stale packs and the LRU evicts them
        self._ef_sel = LRUCache(DECODE_CACHE_SIZE)
        #: per-codec sub-dispatch telemetry, surfaced by the scheduler
        self.codec_dispatches = {"repair": 0, "ef": 0, "bitmap": 0}
        #: cross-query lane dedup toggle — resolved from ``REPRO_DEDUP``
        #: at construction; tests flip it per engine
        self.dedup = DEDUP_ENABLED
        #: bounded probe memo keyed ``(index_version, memo_epoch, algo,
        #: list_id, x)``.  The codec is implied by ``list_id`` — one tier
        #: per engine, assignment fixed at build.  ``swap_index`` builds a
        #: FRESH engine per swap, so the memo is flushed on every hot
        #: swap.
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
        """(Q,) int32 values; INT_INF where no element >= x exists.  With
        a codec tier, lanes split by their list's codec and each
        sub-batch runs that codec's probe path."""
        if self.tier is None:
            return np.asarray(self._next_geq_repair(list_ids, xs))
        return self._route_codecs(list_ids, xs, "svs")

    def member_batch(self, list_ids: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Boolean membership per lane.  Bitmap-coded lists answer with a
        single word test — no probe, no decode; all other lanes reduce to
        ``next_geq == x``."""
        lids = np.asarray(list_ids).ravel()
        xq = np.asarray(xs).ravel()
        if self.tier is None or self.tier.bm is None:
            return np.asarray(self.next_geq_batch(lids, xq)) == xq
        codes = self.tier.codec[lids.astype(np.int64)]
        out = np.zeros(lids.size, dtype=bool)
        bm = np.flatnonzero(codes == CODEC_BITMAP)
        rest = np.flatnonzero(codes != CODEC_BITMAP)
        if rest.size:
            out[rest] = (np.asarray(self.next_geq_batch(lids[rest],
                                                        xq[rest]))
                         == xq[rest])
        if bm.size:
            out[bm] = bitmap_member_np(self.tier.bm, lids[bm], xq[bm])
        return out

    def next_geq_bys_batch(self, list_ids: np.ndarray,
                           xs: np.ndarray) -> np.ndarray:
        """Batched Baeza-Yates-style binary-search next_geq [BY04]; same
        contract as ``next_geq_batch``.  Non-repair lanes route to their
        codec path — EF and bitmap probes ARE position searches already,
        so "bys" only differentiates the repair lanes."""
        if self.tier is None:
            return np.asarray(self._next_geq_repair_bys(list_ids, xs))
        return self._route_codecs(list_ids, xs, "bys")

    def _next_geq_repair_bys(self, list_ids: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """Repair-lane [BY04] probe: the base implementation bisects the
        DECODED list (the classic uncompressed baseline); device engines
        override it with a positional bisection of the compressed
        stream's phrase-sum prefix table
        (``torch_backend.next_geq_bys_batch``)."""
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

    # -- out-of-core storage (DESIGN.md §11) ---------------------------------

    def _init_store(self, page_size: int | None = None) -> None:
        """Materialize the requested page store + admission cache, paged at
        ``page_size`` (the host engine's; the device engines page their
        own index and attach it in ``_attach_store``)."""
        if self._store_kind is None:
            return
        kind = self._store_kind
        self.store = (kind if isinstance(kind, PageStore) else
                      build_page_store(self.res, kind=kind,
                                       page_size=page_size))
        self.resident = ResidentSet(self.store, budget=self._resident_pages)

    def prefault(self, probes=(), score_entries=None) -> None:
        """Fault the union page working set of one tick's merged rounds in
        a single batched gather.  ``probes`` is an iterable of
        ``(list_ids, xs)`` rounds; ``score_entries`` the tick's merged
        ScoreRound lanes.  No-op without a store — and purely an
        optimization with one: every dispatch path re-ensures its own
        working set, prefaulting just coalesces the tick's misses into one
        ``store.gather``."""
        if self.resident is None:
            return
        pages = self.working_set(probes, score_entries)
        if pages.size:
            self.resident.ensure(pages)

    def working_set(self, probes=(), score_entries=None) -> np.ndarray:
        """The union page working set of one tick's merged rounds —
        ``prefault``'s page computation, reused by the scheduler's
        overlapped-prefetch predictor."""
        if self.resident is None:
            return np.empty(0, np.int64)
        groups = []
        for lids, xq in probes:
            lids = np.asarray(lids, np.int64).ravel()
            xq = np.asarray(xq, np.int64).ravel()
            if self.tier is not None and lids.size:
                m = self.tier.codec[lids] == 0   # only Re-Pair lanes
                lids, xq = lids[m], xq[m]        # touch the stream pool
            if lids.size:
                groups.append(self._probe_pages(lids, xq))
        if score_entries is not None:
            e = np.asarray(score_entries, np.int64).ravel()
            if e.size:
                groups.append(self._score_pages(e))
        groups = [g for g in groups if g.size]
        if not groups:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(groups))

    def span_pages(self, term_ids) -> np.ndarray:
        """Pages covering the FULL stream spans of ``term_ids`` — the
        prefetch predictor's superset for queries whose next probe values
        aren't known yet.  Non-repair lanes never touch the stream pool,
        so tiered engines keep only repair-coded lists."""
        if self.resident is None:
            return np.empty(0, np.int64)
        u = np.unique(np.asarray(list(term_ids), np.int64).ravel())
        u = u[(u >= 0) & (u < self.lengths.size)]
        if self.tier is not None and u.size:
            u = u[self.tier.codec[u] == 0]
        if u.size == 0:
            return np.empty(0, np.int64)
        starts = self.store.meta["starts"]
        return pages_in_spans(starts[u], starts[u + 1],
                              self.store.page_size)

    def _probe_pages(self, lids: np.ndarray, xq: np.ndarray) -> np.ndarray:
        """Pages one merged probe round can touch.  Host granularity is
        the full list span (the accessors materialize spans — the paper's
        contiguous-block unit); device engines override with the router's
        per-lane skip windows."""
        starts = self.store.meta["starts"]
        u = np.unique(lids)
        return pages_in_spans(starts[u], starts[u + 1],
                              self.store.page_size)

    def _score_pages(self, entries: np.ndarray) -> np.ndarray:
        """Pages one merged ScoreRound decode can touch."""
        si = self.score_index
        return pages_in_spans(si.pg_sym_lo[entries], si.pg_sym_hi[entries],
                              self.store.page_size)

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
        with span("engine.dispatch_round"):
            return self._dispatch_round(list_ids, xs, algo)

    def _dispatch_round(self, list_ids, xs, algo: str) -> np.ndarray:
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
        """The post-dedup/post-memo slice of a merged round: codec
        routing + backend dispatch."""
        self.lane_stats["dispatched_lanes"] += lids.size
        self._in_round = True
        try:
            if self.tier is None:
                self.codec_dispatches["repair"] += 1
                return np.asarray(self._dispatch_codec(0, lids, xq, algo))
            return self._route_codecs(lids, xq, algo)
        finally:
            self._in_round = False

    def _route_codecs(self, list_ids, xs, algo: str) -> np.ndarray:
        """Split lanes by their list's codec; one sub-dispatch each."""
        lids = np.asarray(list_ids, np.int32).ravel()
        xq = np.asarray(xs, np.int32).ravel()
        codes = self.tier.codec[lids.astype(np.int64)]
        out = np.empty(lids.size, dtype=np.int32)
        for c in np.unique(codes):
            m = np.flatnonzero(codes == c)
            out[m] = np.asarray(
                self._dispatch_codec(int(c), lids[m], xq[m], algo))
            self.codec_dispatches[CODEC_NAMES[int(c)]] += 1
        return out

    def _dispatch_codec(self, codec: int, lids: np.ndarray, xq: np.ndarray,
                        algo: str) -> np.ndarray:
        """One single-codec sub-round (host tier: unpadded; the device
        override pads to the pow2 bucket before delegating here)."""
        if codec == 1:                       # CODEC_EF
            return self._ef_next_geq(lids, xq)
        if codec == 2:                       # CODEC_BITMAP
            return self._bitmap_next_geq(lids, xq)
        if algo == "bys":
            return np.asarray(self._next_geq_repair_bys(lids, xq))
        return np.asarray(self._next_geq_repair(lids, xq))

    # -- codec-tier probe paths ----------------------------------------------

    def _ef_pack(self) -> dict:
        """Select samples (+ backend packs) for the EF store, cached in
        the bounded version-keyed LRU (a hot swap orphans the entry)."""
        key = (self.index_version, "ef")
        pack = self._ef_sel.get(key)
        if pack is None:
            pack = self._build_ef_pack()
            self._ef_sel.put(key, pack)
        return pack

    def _build_ef_pack(self) -> dict:
        return {"samples": self.tier.ef.select_samples()}

    def _ef_next_geq(self, lids, xq) -> np.ndarray:
        return ef_next_geq_np(self.tier.ef, self._ef_pack()["samples"],
                              lids, xq)

    def _bitmap_next_geq(self, lids, xq) -> np.ndarray:
        return bitmap_next_geq_np(self.tier.bm, lids, xq)

    # -- whole-list decode ---------------------------------------------------

    def decode_list(self, i: int) -> np.ndarray:
        """Full expansion of one list to sorted int64 doc ids (cached —
        the boolean executor's merge/union/complement operands)."""
        return self.decode_lists([i])[0]

    def decode_lists(self, ids) -> list[np.ndarray]:
        """:meth:`decode_list` of each id.  The cache is a bounded LRU
        keyed on ``(index_version, i)``; a cached array is returned by
        reference and frozen: an accidental in-place mutation by a caller
        raises instead of silently corrupting every later query that
        touches the list.  The ids not cached yet go to
        :meth:`_decode_lists` in one call."""
        ids = [int(i) for i in ids]
        got = {i: self._decoded.get((self.index_version, i)) for i in ids}
        missing = [i for i, arr in got.items() if arr is None]
        for i, arr in zip(missing, self._decode_lists(missing)):
            arr.flags.writeable = False
            self._decoded.put((self.index_version, i), arr)
            got[i] = arr
        return [got[i] for i in ids]

    def _decode_lists(self, ids: list[int]) -> list[np.ndarray]:
        return [self._decode_list(i) for i in ids]

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
