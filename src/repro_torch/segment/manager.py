"""Segment manager: delta tier, immutable segments, generational
compaction, incremental global BM25 statistics (DESIGN.md §12).

A copy of ``repro/segment/manager.py`` (numpy) for the port, but that a
segment's lists are decoded in one ``Engine.decode_lists`` call where
``repro`` calls ``decode_list`` per list (the port's device decode is an
eager program: a list at a time, its launches cost more than the list's
work, and a segment holds thousands of lists).  Segment
engines come from the serving tier's ``engine_factory``, so on the card
every flushed or compacted segment is served by the same CUDA kernels as
the base index; a builder named by string comes from
``repro_torch.build.make_builder`` (device builders default to the card).

Correctness skeleton (what the differential gate leans on):

* **Domain partition.**  Segments (plus the delta) cover contiguous,
  disjoint document-id ranges ``[base, base + num_docs)`` in order, so
  boolean set algebra distributes over them: evaluating a query per part
  against the part's local domain and concatenating ``base + local``
  answers IS the global answer, bit-identically — including ``NOT``,
  whose complement splits into per-part complements.
* **Exact global BM25.**  A document's length (number of distinct terms)
  is fixed at insert; only the *collection* statistics (df, N, avgdl)
  move.  The manager maintains them incrementally and rebuilds the f32
  ``idf`` / ``doc_w`` tables per **stats epoch** (= one per insert).
  Per-segment scoring uses the global tables sliced to the segment
  (``idf[terms]``, ``doc_w[base:base+n]``), and the fixed-order f32
  reduction is order-isomorphic under the monotone local↔global term
  remap — so every score equals the rebuilt-from-scratch score bitwise.
* **Block-max refresh in O(entries).**  A segment's page directory
  geometry is stats-independent; only the admission bounds move with the
  epoch.  ``doc_w`` is monotone non-increasing in document length (f64
  math, one monotone f32 rounding), so each entry's bound is exactly
  ``f32(idf[t] * doc_w(min_dl(entry)))`` — the per-entry minimum length
  is captured once at segment build and the refresh is two vectorized
  ops, not a directory rebuild.

Crash contract (the ``PipelineCursor`` shape): the delta tier is a pure
function of the mutation log past ``cursor``; flush commits a fully-built
segment with single reference assignments (a killed flush leaves the
previous segment set serving); compaction is a pure function of the
immutable segment contents, hence idempotent on replay.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..core.index import (bm25_doc_weights, bm25_idf, build_score_index)
from ..core.repair import RePairResult
from ..query import QueryExecutor
from ..query.ast import And, Node, Not, Or, Phrase, Term
from ..query.plan import ListStats

#: delta-tier budget in documents (env ``REPRO_DELTA_BUDGET``): an insert
#: that leaves more than this many documents unflushed triggers a flush
DELTA_BUDGET_ENV = "REPRO_DELTA_BUDGET"
DEFAULT_DELTA_BUDGET = 256

#: merge width of one generational compaction step (env
#: ``REPRO_COMPACT_FANOUT``): a run of this many consecutive
#: same-generation segments merges into one segment of the next
#: generation — classic tiered LSM shape, so the segment count stays
#: O(fanout · log(ingested / budget))
COMPACT_FANOUT_ENV = "REPRO_COMPACT_FANOUT"
DEFAULT_COMPACT_FANOUT = 4

#: generation of the bootstrap segment — effectively infinite, so the
#: seed index never enters a compaction run (there is only one of it)
_BASE_GEN = 1 << 30


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else int(default)


@dataclasses.dataclass
class GlobalStats:
    """One stats epoch's frozen global BM25 tables.  ``epoch`` counts
    inserts; the arrays are never mutated after construction, so a query
    machine holding a reference across scheduler ticks stays coherent."""

    epoch: int
    ndocs: int
    avgdl: float
    idf: np.ndarray        # (num_terms,) f32
    doc_w: np.ndarray      # (total_docs,) f32
    dl: np.ndarray         # (total_docs,) int64


class Segment:
    """One immutable index over a contiguous document range.

    ``terms`` maps local list ids to global term ids (sorted — segments
    only store their NON-empty lists, because Re-Pair's gap stream cannot
    encode an empty list).  ``engine is None`` marks a *blank* segment
    (a flushed run of termless documents): it still owns its document
    range (``NOT`` complements against it) but carries no index.
    """

    __slots__ = ("version", "base", "num_docs", "gen", "terms", "res",
                 "engine", "dl_local", "_executors", "_lstats", "_skel",
                 "_si", "_si_epoch")

    def __init__(self, version: int, base: int, num_docs: int, gen: int,
                 terms: np.ndarray, res: RePairResult | None, engine,
                 dl_local: np.ndarray):
        self.version = int(version)
        self.base = int(base)
        self.num_docs = int(num_docs)
        self.gen = int(gen)
        self.terms = np.asarray(terms, np.int64)
        self.res = res
        self.engine = engine
        self.dl_local = np.asarray(dl_local, np.int64)
        self._executors: dict = {}
        self._lstats: ListStats | None = None
        self._skel = None
        self._si = None
        self._si_epoch = -1

    # -- term remapping ---------------------------------------------------

    def local_term(self, t: int) -> int:
        """Global term id -> local list id, or -1 when the segment holds
        no postings for it (-1 flows through the planner as an
        out-of-vocabulary term: empty list, full complement)."""
        i = int(np.searchsorted(self.terms, int(t)))
        if i < self.terms.size and int(self.terms[i]) == int(t):
            return i
        return -1

    def local_node(self, node: Node) -> Node:
        """The query AST with every global term id remapped to this
        segment's local list id."""
        if isinstance(node, Term):
            return Term(self.local_term(node.t))
        if isinstance(node, And):
            return And(tuple(self.local_node(c) for c in node.children))
        if isinstance(node, Or):
            return Or(tuple(self.local_node(c) for c in node.children))
        if isinstance(node, Not):
            return Not(self.local_node(node.child))
        if isinstance(node, Phrase):
            return Phrase(tuple(self.local_term(t) for t in node.terms))
        raise TypeError(f"not a query node: {node!r}")

    # -- per-segment execution machinery ----------------------------------

    def executor(self, force_algo: str | None) -> QueryExecutor:
        """Planner/executor bound to this segment's engine and LOCAL
        domain; one per forced algorithm, sharing one ListStats (the same
        lazy layout the scheduler uses for the static tier)."""
        ex = self._executors.get(force_algo)
        if ex is None:
            if self._lstats is None:
                self._lstats = ListStats.from_engine(self.engine,
                                                     domain=self.num_docs)
            ex = QueryExecutor(self.engine, force_algo=force_algo,
                               stats=self._lstats)
            self._executors[force_algo] = ex
        return ex

    def _skeleton(self):
        """Stats-independent scoring skeleton, built once: the block-max
        page directory geometry plus, per entry and per list, the MINIMUM
        document length among its documents — everything an epoch refresh
        needs to recompute exact admission bounds in O(entries)."""
        if self._skel is None:
            si = build_score_index(self.res,
                                   page_size=self.engine._score_page_size())
            E = int(si.pg_count.size)
            L = int(self.terms.size)
            lists = self.engine.decode_lists(range(L))
            entry_min_dl = np.ones(E, np.int64)
            for e in range(E):
                lo = int(si.pg_elem_lo[e])
                docs = lists[int(si.pg_list[e])]
                docs = docs[lo:lo + int(si.pg_count[e])]
                entry_min_dl[e] = int(self.dl_local[docs].min())
            list_min_dl = np.ones(L, np.int64)
            for i in range(L):
                list_min_dl[i] = int(self.dl_local[lists[i]].min())
            self._skel = (si, entry_min_dl, list_min_dl)
        return self._skel

    def score_si(self, stats: GlobalStats):
        """This segment's ScoreIndex under the global statistics of
        ``stats.epoch``: global tables sliced to the segment, admission
        bounds recomputed from the skeleton.  ``doc_w`` is monotone
        non-increasing in dl and ``idf >= 0``, and f32 rounding/multiply
        preserve monotonicity, so ``f32(idf * doc_w(min_dl))`` equals the
        max over the entry's already-rounded f32 contributions — the
        exact bound a from-scratch directory build would store."""
        if self._si is not None and self._si_epoch == stats.epoch:
            return self._si
        si, entry_min_dl, list_min_dl = self._skeleton()
        idf_l = stats.idf[self.terms]
        doc_w_l = stats.doc_w[self.base:self.base + self.num_docs]
        wmax = bm25_doc_weights(entry_min_dl, stats.avgdl)
        ub = (idf_l[si.pg_list] * wmax).astype(np.float32)
        lmax = (idf_l * bm25_doc_weights(list_min_dl, stats.avgdl)
                ).astype(np.float32)
        out = dataclasses.replace(
            si, idf=idf_l, doc_w=doc_w_l, list_max=lmax,
            pg_ub=ub, pg_wmax=wmax,
            ndocs=stats.ndocs, avgdl=stats.avgdl)
        self._si, self._si_epoch = out, stats.epoch
        # keep the engine's own scoring tier in step so direct engine
        # callers (decode_page_batch geometry, score_batch) see the same
        # tables the machine scores with
        self.engine.set_score_index(out)
        return out


@dataclasses.dataclass(frozen=True)
class SegmentView:
    """Immutable per-query snapshot, captured at submit: the segment
    tuple, the delta tier's document range, and the delta postings of
    exactly the query's terms (local ids).  Later inserts/flushes/
    compactions replace manager REFERENCES, never mutate contents, so a
    parked machine holding a view stays consistent across ticks."""

    segments: tuple[Segment, ...]
    delta_base: int
    delta_docs: int
    delta_lists: dict[int, np.ndarray]
    num_terms: int

    @property
    def total_docs(self) -> int:
        return self.delta_base + self.delta_docs


class SegmentedIndex:
    """The mutable manager: mutation log + delta tier + segment set.

    ``engine_factory(res)`` stands up one engine per segment with the
    serving tier's construction knobs (codec/store/mesh/page size), so
    every segment gets its own decode LRU and — out of core — its own
    page store + resident pool, extending the per-store admission-cache
    design (DESIGN.md §11) to the segment set structurally.
    """

    def __init__(self, res: RePairResult, engine, engine_factory, *,
                 builder="host", build_cfg=None,
                 delta_budget: int | None = None,
                 compact_fanout: int | None = None):
        from ..build import Builder, make_builder
        if not isinstance(builder, Builder):
            builder = make_builder(builder, build_cfg)
        self._builder = builder
        self._factory = engine_factory
        self.delta_budget = (delta_budget if delta_budget is not None
                             else _env_int(DELTA_BUDGET_ENV,
                                           DEFAULT_DELTA_BUDGET))
        self.compact_fanout = max(2, (compact_fanout
                                      if compact_fanout is not None
                                      else _env_int(COMPACT_FANOUT_ENV,
                                                    DEFAULT_COMPACT_FANOUT)))
        # bootstrap global statistics from the seed index — identical to
        # what build_score_index derives, so the segmented scores match a
        # from-scratch build from the first insert on
        base_n = int(res.universe)
        dl = np.zeros(max(1, base_n), np.int64)
        for i in range(res.num_lists):
            dl[res.decode_list(i)] += 1
        self.num_terms = int(res.num_lists)
        self._df = np.asarray(res.orig_lengths, np.int64).copy()
        self._dl: list[int] = dl[:base_n].tolist()
        self._base0 = base_n
        self._next_version = 0
        seg0 = Segment(self._new_version(), 0, base_n, _BASE_GEN,
                       np.arange(res.num_lists, dtype=np.int64), res,
                       engine, dl[:base_n])
        self.segments: tuple[Segment, ...] = (seg0,)
        #: the mutation log: per-document sorted unique term arrays,
        #: append-only; ``cursor`` = documents already flushed into
        #: segments — the whole delta tier is log[cursor:], the
        #: one-integer-resume contract of :class:`PipelineCursor`
        self._log: list[np.ndarray] = []
        self.cursor = 0
        self._delta_inv: dict[int, list[int]] = {}
        self._stats: GlobalStats | None = None
        # telemetry
        self.flushes = 0
        self.flush_ms = 0.0
        self.compactions = 0

    def _new_version(self) -> int:
        self._next_version += 1
        return self._next_version

    # -- state ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Content epoch: one per insert.  Flush/compaction do NOT bump
        it — they move postings between tiers without changing answers,
        so result caches keyed on it survive reorganization."""
        return len(self._log)

    @property
    def delta_docs(self) -> int:
        return len(self._log) - self.cursor

    @property
    def total_docs(self) -> int:
        return self._base0 + len(self._log)

    def log_entry(self, i: int) -> np.ndarray:
        """Mutation-log record ``i`` (terms of inserted document
        ``base0 + i``) — replay/audit accessor."""
        return self._log[i]

    def global_stats(self) -> GlobalStats:
        """The current epoch's global BM25 tables (cached per epoch)."""
        if self._stats is None or self._stats.epoch != self.epoch:
            dl = np.asarray(self._dl, np.int64)
            ndocs = int((dl > 0).sum())
            avgdl = float(dl.sum() / max(ndocs, 1))
            idf = bm25_idf(self._df[:self.num_terms], ndocs)
            doc_w = bm25_doc_weights(dl, avgdl)
            self._stats = GlobalStats(self.epoch, ndocs, avgdl, idf,
                                      doc_w, dl)
        return self._stats

    def snapshot(self, terms) -> SegmentView:
        """Capture the consistent view one query evaluates against."""
        base = self._base0 + self.cursor
        dlists: dict[int, np.ndarray] = {}
        for t in {int(t) for t in terms}:
            g = self._delta_inv.get(t)
            if g:
                dlists[t] = np.asarray(g, np.int64) - base
        return SegmentView(self.segments, base, self.delta_docs, dlists,
                           self.num_terms)

    # -- writes -----------------------------------------------------------

    def insert(self, terms) -> int:
        """Insert one document; returns its global doc id.  Visible to
        the next submitted query immediately (delta tier); flushes the
        delta through the build backend when it exceeds the budget."""
        terms = np.unique(np.asarray(list(terms), np.int64).reshape(-1))
        if terms.size and int(terms[0]) < 0:
            raise ValueError("negative term id")
        gid = self.total_docs
        hi = int(terms[-1]) + 1 if terms.size else 0
        if hi > self.num_terms:
            grown = np.zeros(hi, np.int64)
            grown[:self._df.size] = self._df
            self._df = grown
            self.num_terms = hi
        self._log.append(terms)
        self._df[terms] += 1
        self._dl.append(int(terms.size))
        for t in terms.tolist():
            self._delta_inv.setdefault(int(t), []).append(gid)
        self._stats = None
        if self.delta_docs > self.delta_budget:
            self.flush()
        return gid

    def flush(self) -> Segment | None:
        """Freeze the delta tier into one immutable Re-Pair segment.
        Everything is built off to the side; the commit is two reference
        assignments at the end — a crash mid-flush leaves the previous
        (segments, cursor) pair serving, and replaying the log past
        ``cursor`` reproduces the lost delta exactly."""
        n = self.delta_docs
        if n == 0:
            return None
        t0 = time.perf_counter()
        base = self._base0 + self.cursor
        inv: dict[int, list[int]] = {}
        for j, terms in enumerate(self._log[self.cursor:]):
            for t in terms.tolist():
                inv.setdefault(int(t), []).append(j)
        dl_local = np.asarray([int(t.size) for t in
                               self._log[self.cursor:]], np.int64)
        lists_by_term = {t: np.asarray(d, np.int64) for t, d in inv.items()}
        seg = self._build_segment(base, n, lists_by_term, gen=0,
                                  dl_local=dl_local)
        # atomic commit
        self.segments = self.segments + (seg,)
        self.cursor = len(self._log)
        self._delta_inv = {}
        self.flushes += 1
        self.flush_ms += (time.perf_counter() - t0) * 1e3
        return seg

    def _build_segment(self, base: int, n: int,
                       lists_by_term: dict[int, np.ndarray], gen: int,
                       dl_local: np.ndarray) -> Segment:
        version = self._new_version()
        if not lists_by_term:          # termless run: domain-only segment
            return Segment(version, base, n, gen,
                           np.empty(0, np.int64), None, None, dl_local)
        terms = np.asarray(sorted(lists_by_term), np.int64)
        lists = [lists_by_term[int(t)] for t in terms.tolist()]
        res = self._builder.build_grammar(lists)
        eng = self._factory(res)
        eng.index_version = version
        return Segment(version, base, n, gen, terms, res, eng, dl_local)

    # -- generational compaction ------------------------------------------

    def _find_run(self) -> int:
        """Start index of the left-most lowest-generation run of
        ``compact_fanout`` consecutive same-generation segments; -1 when
        no run exists."""
        segs, f = self.segments, self.compact_fanout
        best, best_gen = -1, None
        i = 0
        while i + f <= len(segs):
            g = segs[i].gen
            if all(s.gen == g for s in segs[i:i + f]):
                if best_gen is None or g < best_gen:
                    best, best_gen = i, g
            i += 1
        return best

    def compact_step(self) -> bool:
        """One background merge: the scheduler calls this between ticks.
        Merges one run of ``compact_fanout`` same-generation segments
        into a segment of the next generation.  A pure function of the
        immutable inputs + a single reference swap, so replaying it after
        a crash converges to the same segment set (idempotent)."""
        j = self._find_run()
        if j < 0:
            return False
        f = self.compact_fanout
        group = self.segments[j:j + f]
        base = group[0].base
        inv: dict[int, list[np.ndarray]] = {}
        for g in group:
            if g.engine is None:       # blank segment: no lists to merge
                continue
            off = g.base - base
            decoded = g.engine.decode_lists(range(g.terms.size))
            for li, t in enumerate(g.terms.tolist()):
                docs = np.asarray(decoded[li], np.int64)
                inv.setdefault(int(t), []).append(docs + off)
        # groups are base-ordered and disjoint, so per-term concatenation
        # is already sorted
        lists_by_term = {t: np.concatenate(v) for t, v in inv.items()}
        n = sum(g.num_docs for g in group)
        dl_local = np.concatenate([g.dl_local for g in group])
        seg = self._build_segment(base, n, lists_by_term,
                                  gen=group[0].gen + 1, dl_local=dl_local)
        self.segments = (self.segments[:j] + (seg,)
                         + self.segments[j + f:])
        self.compactions += 1
        return True

    def maybe_compact(self) -> bool:
        """At most one merge step — the between-ticks background hook."""
        return self.compact_step()

    def compact(self) -> int:
        """Run compaction to quiescence; returns merge steps performed."""
        k = 0
        while self.compact_step():
            k += 1
        return k

    # -- query lowering (machines live in lowering.py) ---------------------

    def lower_bool(self, node: Node, force_algo: str | None = None):
        """Step machine of one boolean query over the segmented index.
        The view is snapshotted HERE (not at first advance), so a machine
        parked on the scheduler is pinned to the submit-time state."""
        from .lowering import bool_machine
        from ..query.ast import terms_of
        view = self.snapshot(terms_of(node))
        return bool_machine(view, node, force_algo)

    def lower_topk(self, terms, k: int, *, prune: bool = True):
        """Step machine of one ranked top-k query over delta + segments,
        exact under the CURRENT global statistics."""
        from .lowering import topk_machine
        ts = sorted({int(t) for t in terms if 0 <= int(t) < self.num_terms})
        view = self.snapshot(ts)
        return topk_machine(view, self.global_stats(), ts, int(k),
                            prune=prune)

    # -- observability -----------------------------------------------------

    def telemetry(self) -> dict:
        return {"segments": len(self.segments),
                "delta_docs": self.delta_docs,
                "ingested_docs": len(self._log),
                "flushes": self.flushes,
                "flush_ms": self.flush_ms,
                "compactions": self.compactions}
