"""Cross-query batching runtime: admission queue + microbatcher over the
resumable step machines (DESIGN.md §8).

One query at a time, the engine seam is wasted: every conjunctive step
dispatches a probe batch shaped like ONE candidate set, and per-dispatch
overhead (host→device hops, jit-entry lookup, kernel launch) dominates at
serving rates.  The scheduler amortizes it the way production engines do
— batch the probes, not the queries:

* ``submit`` plans the query against the live index and parks its lowered
  step machine (``QueryExecutor.lower``) on an admission queue;
* each ``tick`` admits up to ``batch_window`` queries in flight, advances
  every machine through its host steps (``SetOp``/``PhraseShift``/
  ``DecodeList``) until it blocks on a :class:`ProbeRound`, concatenates
  the pending rounds of ALL blocked queries into one
  ``engine.dispatch_round`` per (engine, algorithm), and scatters each
  query's slice of the answers back into its continuation.  With an
  adaptive codec tier (DESIGN.md §10.3) the engine splits that merged
  round by per-list codec, so the effective coalescing key at the device
  boundary is (engine, codec, algorithm) — still one device dispatch per
  codec present per tick, counted in ``stats()["codec_dispatches"]``;
* queries complete **out of order** — a bare-term query admitted last
  finishes on its first advance while a 4-term meld keeps ticking.

Probe primitives are elementwise in the (list, probe) lanes, so a merged
dispatch returns bit-identical values to per-query dispatches — the
differential gate in ``tests/test_scheduler.py`` holds the whole runtime
to that.

Ranked top-k queries (DESIGN.md §9) ride the SAME loop: ``submit_topk``
parks a :func:`~repro_torch.query.topk.lower_topk` machine whose
:class:`ScoreRound` page decodes merge across queries exactly like probe
rounds (one ``dispatch_score_round`` per engine per tick) and whose
membership probes merge with boolean traffic in the "svs" probe group.
The heap — and the pruning threshold it carries — lives in the
generator frame, so pruning decisions straddle scheduler ticks.

Two caches ride the tick loop, both keyed on the **index version** and
flushed by ``QueryServer.swap_index`` so hot rebuilds stay correct
(DESIGN.md §8.3): a decoded-list LRU serving ``DecodeList`` steps across
queries, and a query-result LRU short-circuiting repeated queries (Zipf
workloads repeat the head constantly).  Result keys carry the query
MODE ("bool"/"topk") and, for ranked queries, the term bag, ``k`` and
the pruning flag — a boolean query and a ranked query over the same
terms, or the same ranked query at two ``k``, can never collide.
In-flight queries pin the engine and version they were planned against,
so a mid-workload swap never mixes indexes inside one machine.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from ..core.cache import LRUCache
from ..engine.base import _env_flag
from ..obs import span
from ..query import QueryExecutor
from ..query.ast import And, Node, Not, Or, Phrase, Term, terms_of
from ..query.parser import parse
from ..query.plan import ListStats
from ..query.steps import DecodeList, ProbeRound, ScoreRound
from ..query.topk import RankedResult, lower_topk

#: in-flight window of the microbatcher (env ``REPRO_BATCH_WINDOW``);
#: 1 degenerates to serial execution — the CI matrix pins that
DEFAULT_BATCH_WINDOW = int(os.environ.get("REPRO_BATCH_WINDOW", "32"))

#: per-query/per-dispatch telemetry (latencies, completion order, merge
#: widths) is kept over a sliding window so a long-lived server's
#: bookkeeping stays bounded; cumulative counts are separate integers
TELEMETRY_WINDOW = 65536

#: overlapped page prefetch for out-of-core engines (DESIGN.md §13.3);
#: ``REPRO_PREFETCH=0`` restores the serial fault-then-dispatch tick
PREFETCH_ENABLED = _env_flag("REPRO_PREFETCH", True)

#: the merged-round lane counters every engine carries — the scheduler
#: accumulates per-dispatch deltas so totals survive segment-engine
#: churn and cover every engine a tick touches
_LANE_KEYS = ("real_lanes", "unique_lanes", "pad_lanes",
              "dispatched_lanes", "memo_hits", "memo_misses")


def _term_bag(q) -> list[int]:
    """Bag of words of a query in any accepted form (string / AST node /
    term-id sequence) — the segmented ranked path needs it without a
    bound executor."""
    if isinstance(q, str):
        return terms_of(parse(q, None))
    if isinstance(q, (And, Or, Not, Phrase, Term)):
        return terms_of(q)
    return [int(t) for t in q]


class _InFlight:
    """One admitted query: its step machine (the continuation), the
    engine/version it was planned against, and its pending probe round."""

    __slots__ = ("qid", "machine", "engine", "version", "key", "t0",
                 "pending", "rounds", "done", "terms")

    def __init__(self, qid, machine, engine, version, key, t0,
                 terms=None):
        self.qid = qid
        self.machine = machine
        self.engine = engine
        self.version = version
        self.key = key
        self.t0 = t0
        self.pending: ProbeRound | None = None
        self.rounds = 0
        self.done = False
        #: term bag captured at submit — the prefetch predictor's page
        #: superset for machines that haven't yielded a round yet
        self.terms = terms


class QueryScheduler:
    """Admission queue + coalescing tick loop over one live engine.

    ``batch_window`` bounds the in-flight queries whose rounds may merge;
    ``version`` is the index-version token in every cache key.  The
    scheduler builds one :class:`QueryExecutor` per forced algorithm
    lazily (sharing one :class:`ListStats`), so repeated
    ``force_algo`` queries stop re-deriving planner statistics.
    """

    def __init__(self, engine, *, batch_window: int | None = None,
                 version: int = 0, decode_cache_size: int = 256,
                 result_cache_size: int = 512,
                 prefetch: bool | None = None):
        self.batch_window = max(1, int(batch_window if batch_window
                                       is not None else
                                       DEFAULT_BATCH_WINDOW))
        self.decode_cache = LRUCache(decode_cache_size)
        self.result_cache = LRUCache(result_cache_size)
        self.completion_order: deque[int] = deque(maxlen=TELEMETRY_WINDOW)
        self.latencies: deque[float] = deque(maxlen=TELEMETRY_WINDOW)
        # queries per merged dispatch (recent window)
        self._dispatch_widths: deque[int] = deque(maxlen=TELEMETRY_WINDOW)
        self._merged_lanes = 0
        self._dispatches = 0
        # merged-round lane accounting (DESIGN.md §13.4): per-dispatch
        # deltas of each engine's ``lane_stats`` counters
        self._lane_totals = dict.fromkeys(_LANE_KEYS, 0)
        # overlapped prefetch (DESIGN.md §13.3): one background thread per
        # tick runs the predicted next-tick gather; joined at the top of
        # the NEXT tick before anything touches the pools
        self.prefetch = (PREFETCH_ENABLED if prefetch is None
                         else bool(prefetch))
        self._pf_thread: threading.Thread | None = None
        self._pf_jobs: list[tuple[object, np.ndarray]] = []
        self._pf_results: list = []
        self._pf_gather_s = 0.0         # written once by the thread,
        #                                 read after join — no race
        self.prefetch_gather_ms = 0.0
        self.prefetch_join_wait_ms = 0.0
        self.overlap_ms = 0.0
        self.prefetched_pages = 0
        self.prefetch_useful = 0
        self._completed = 0
        self.failures = 0
        # ranked-retrieval counters (cumulative; survive hot swaps so a
        # long-lived server's pruning efficacy is observable end to end)
        self.pages_scored = 0
        self.pages_skipped = 0
        self.threshold_final = 0.0   # θ of the most recent ranked query
        self._next_qid = 0
        self._ticks = 0
        self._queue: deque[_InFlight] = deque()
        self._running: list[_InFlight] = []
        self._done: dict[int, np.ndarray] = {}
        # (submit_time, completion_time) of recent completions — qps is
        # computed over this window so it reflects current throughput,
        # not a lifetime average diluted by idle gaps
        self._spans: deque[tuple[float, float]] = deque(
            maxlen=TELEMETRY_WINDOW)
        #: streaming-ingestion mode (DESIGN.md §12): when a
        #: :class:`~repro_torch.segment.SegmentedIndex` is attached, queries
        #: lower through it (delta + per-segment machines, rounds tagged
        #: with their segment's engine) and ``tick`` runs one background
        #: compaction step after scattering — never blocking in-flight
        #: queries, which hold immutable snapshots of the segment set
        self.segmented = None
        self._bind(engine, version)

    # -- index hot-swap ------------------------------------------------------

    def _bind(self, engine, version: int) -> None:
        self._engine = engine
        self._version = int(version)
        self._executors: dict[str | None, QueryExecutor] = {}
        self._stats: ListStats | None = None

    def swap(self, engine, version: int) -> None:
        """Rebind to a hot-swapped index: flush both per-index caches and
        drop the executors (planner statistics are per-index).  Queries
        already in flight pinned their engine/version at submit time and
        finish on the OLD index — the same queries-in-flight semantics as
        ``QueryServer.swap_index``.  A segmented manager wraps the OLD
        engine as its base segment, so a swap drops it (the server
        re-attaches one if ingest continues on the new index)."""
        self._bind(engine, version)
        self.segmented = None
        self.decode_cache.flush()
        self.result_cache.flush()

    def _executor(self, force_algo: str | None) -> QueryExecutor:
        ex = self._executors.get(force_algo)
        if ex is None:
            if self._stats is None:
                self._stats = ListStats.from_engine(self._engine)
            ex = QueryExecutor(self._engine, force_algo=force_algo,
                               stats=self._stats)
            self._executors[force_algo] = ex
        return ex

    # -- admission -----------------------------------------------------------

    def submit(self, q, force_algo: str | None = None) -> int:
        """Plan a query against the live index and enqueue its step
        machine; returns the query id for :meth:`take`.  A result-cache
        hit completes immediately (no machine, no rounds)."""
        qid = self._next_qid
        self._next_qid += 1
        with span("query.submit", qid=qid):
            return self._submit(qid, q, force_algo)

    def _submit(self, qid: int, q, force_algo: str | None) -> int:
        t0 = time.perf_counter()
        if self.segmented is not None:
            # segmented mode: the machine snapshots delta + segments at
            # submit; the key folds in the CONTENT epoch (one per insert —
            # flush/compaction reorganize without changing answers, so
            # cached results survive them)
            node = parse(q, None) if isinstance(q, str) else q
            key = (self._version, "bool-seg", self.segmented.epoch,
                   force_algo, node)
            hit = self.result_cache.get(key)
            if hit is not None:
                self._finish(qid, hit.copy(), t0)
                return qid
            fl = _InFlight(qid, self.segmented.lower_bool(node, force_algo),
                           self._engine, self._version, key, t0,
                           terms=terms_of(node))
            self._queue.append(fl)
            return fl.qid
        ex = self._executor(force_algo)
        node = parse(q, ex.term_map) if isinstance(q, str) else q
        key = (self._version, "bool", force_algo, node)
        hit = self.result_cache.get(key)
        if hit is not None:
            self._finish(qid, hit.copy(), t0)
            return qid
        fl = _InFlight(qid, ex.lower(ex.plan(node)), self._engine,
                       self._version, key, t0, terms=terms_of(node))
        self._queue.append(fl)
        return fl.qid

    def submit_topk(self, q, k: int = 10, *, prune: bool = True) -> int:
        """Enqueue one ranked top-k query (a term bag — a query string,
        an AST node, or a term-id sequence; only its terms matter).  The
        result is a :class:`~repro_torch.query.topk.RankedResult` from
        :meth:`take`.  The cache key folds in the scoring mode, the term
        bag, ``k`` AND the pruning flag, so ranked results never collide
        with boolean results or with each other across ``k``."""
        qid = self._next_qid
        self._next_qid += 1
        with span("query.submit", qid=qid):
            return self._submit_topk(qid, q, k, prune)

    def _submit_topk(self, qid: int, q, k: int, prune: bool) -> int:
        t0 = time.perf_counter()
        if self.segmented is not None:
            terms = tuple(sorted({int(t) for t in _term_bag(q)
                                  if 0 <= int(t)
                                  < self.segmented.num_terms}))
            key = (self._version, "topk-seg", self.segmented.epoch,
                   terms, int(k), bool(prune))
            hit = self.result_cache.get(key)
            if hit is not None:
                self._finish(qid, hit.copy(), t0)
                return qid
            fl = _InFlight(qid,
                           self.segmented.lower_topk(terms, int(k),
                                                     prune=prune),
                           self._engine, self._version, key, t0,
                           terms=list(terms))
            self._queue.append(fl)
            return fl.qid
        terms = tuple(self._executor(None).query_terms(q))
        key = (self._version, "topk", terms, int(k), bool(prune))
        hit = self.result_cache.get(key)
        if hit is not None:
            self._finish(qid, hit.copy(), t0)
            return qid
        fl = _InFlight(qid, lower_topk(self._engine.score_index, terms,
                                       int(k), prune=prune),
                       self._engine, self._version, key, t0,
                       terms=list(terms))
        self._queue.append(fl)
        return fl.qid

    def take(self, qid: int) -> np.ndarray:
        """Pop a completed query's result (KeyError if not done yet)."""
        return self._done.pop(qid)

    # -- the coalescing tick -------------------------------------------------

    def tick(self) -> int:
        """One scheduler round: admit, advance to the next suspension
        point, one merged dispatch per (engine, algorithm), scatter.
        Returns the number of queries still in flight or queued.

        With an out-of-core engine and prefetch on, each tick ALSO
        predicts the next tick's page working set and runs its store
        gather on a background thread, double-buffered against this
        tick's dispatches (DESIGN.md §13.3).  The thread is joined — and
        its pages admitted — at the top of the next tick, before any
        code touches the resident pools."""
        self._ticks += 1
        with span("scheduler.tick", tick=self._ticks):
            return self._tick()

    def _tick(self) -> int:
        self._join_prefetch()
        while self._queue and len(self._running) < self.batch_window:
            fl = self._queue.popleft()
            self._running.append(fl)
            self._advance(fl, None, start=True)
        # a round may carry its own engine (segmented execution tags every
        # round with its segment's engine, DESIGN.md §12) — resolve it per
        # round, so the coalescing key stays (engine, algo) and rounds of
        # the SAME segment merge across queries while distinct segments
        # dispatch separately
        groups: dict[tuple, tuple[object, list[_InFlight]]] = {}
        for fl in self._running:
            if fl.pending is not None:
                eng = (fl.pending.engine if fl.pending.engine is not None
                       else fl.engine)
                tag = (("score",) if isinstance(fl.pending, ScoreRound)
                       else ("probe", fl.pending.algo))
                groups.setdefault((id(eng),) + tag,
                                  (eng, []))[1].append(fl)
        # fault the tick's page working set BETWEEN rounds: one batched
        # store gather per engine per tick covering every merged group, so
        # the dispatches below run against an already-hot resident pool
        # and the kernel launch shapes stay deterministic (DESIGN.md §11.3)
        faulting: dict[int, tuple[object, list, list]] = {}
        for gkey, (eng, fls) in groups.items():
            if getattr(eng, "resident", None) is None:
                continue
            probes, scores = faulting.setdefault(
                gkey[0], (eng, [], []))[1:]
            for r in (fl.pending for fl in fls):
                if isinstance(r, ScoreRound):
                    scores.append(np.asarray(r.entries))
                else:
                    probes.append((np.asarray(r.list_ids),
                                   np.asarray(r.xs)))
        # harvest prefetch-usefulness deltas over the prefault+dispatch
        # window: demand hits on speculatively admitted pages
        pf_res = {}
        for eng, _p, _s in faulting.values():
            res = eng.resident
            pf_res.setdefault(id(res), (res, res.prefetch_useful))
        for eng, probes, scores in faulting.values():
            eng.prefault(probes,
                         np.concatenate(scores) if scores else None)
        if self.prefetch:
            self._launch_prefetch(groups)
        first_err: BaseException | None = None
        for gkey, (eng, fls) in groups.items():
            rounds = [fl.pending for fl in fls]
            self._dispatch_widths.append(len(fls))
            self._dispatches += 1
            lane_snap = dict(eng.lane_stats)
            if gkey[1] == "score":      # merged ranked page decode
                entries = np.concatenate([r.entries for r in rounds])
                self._merged_lanes += int(entries.size)
                vals = np.asarray(eng.dispatch_score_round(entries))
            else:
                algo = gkey[2]
                lids = np.concatenate([r.list_ids for r in rounds])
                xs = np.concatenate([r.xs for r in rounds])
                self._merged_lanes += int(lids.size)
                vals = np.asarray(eng.dispatch_round(lids, xs, algo))
            for k in _LANE_KEYS:
                self._lane_totals[k] += eng.lane_stats[k] - lane_snap[k]
            off = 0
            for fl, r in zip(fls, rounds):
                seg = vals[off:off + r.size]
                off += r.size
                fl.pending = None
                fl.rounds += 1
                try:
                    self._advance(fl, seg)
                except BaseException as e:   # noqa: BLE001 — re-raised below
                    # finish scattering first: the siblings' slices of
                    # this dispatch would otherwise be thrown away and
                    # their probes re-dispatched (duplicate device work,
                    # double-counted telemetry)
                    if first_err is None:
                        first_err = e
        self._running = [fl for fl in self._running if not fl.done]
        for res, before in pf_res.values():
            self.prefetch_useful += res.prefetch_useful - before
        if first_err is not None:
            raise first_err
        # background merge BETWEEN rounds: at most one generational
        # compaction step per tick; queries in flight hold immutable
        # segment-set snapshots, so this never blocks or perturbs them
        if self.segmented is not None:
            self.segmented.maybe_compact()
        left = len(self._running) + len(self._queue)
        if left == 0:
            # drained: join the tail prefetch so no thread outlives the
            # workload (and its pages still land for the next burst)
            self._join_prefetch()
        return left

    # -- overlapped prefetch (DESIGN.md §13.3) -------------------------------

    def _launch_prefetch(self, groups) -> None:
        """Predict the NEXT tick's page working set and start its store
        gather on a background thread.  Predictions: (a) the full list
        spans of every round dispatched THIS tick — continuations re-probe
        the same lists at advanced frontiers; (b) the term bags of
        queued-but-unstarted machines — their first rounds probe those
        lists.  The thread only runs read-only ``store.gather`` calls
        into staging arrays; all pool mutation happens at join time on
        the main thread (``ResidentSet.admit_prefetched``)."""
        if self._pf_thread is not None:     # never two threads in flight
            return
        per_eng: dict[int, tuple[object, set]] = {}
        for _gkey, (eng, fls) in groups.items():
            if getattr(eng, "resident", None) is None:
                continue
            terms = per_eng.setdefault(id(eng), (eng, set()))[1]
            for fl in fls:
                r = fl.pending
                if isinstance(r, ProbeRound):
                    terms.update(int(t) for t in np.unique(
                        np.asarray(r.list_ids)).tolist())
                elif fl.terms:
                    terms.update(int(t) for t in fl.terms)
        for fl in self._queue:
            eng = fl.engine
            if getattr(eng, "resident", None) is None or not fl.terms:
                continue
            terms = per_eng.setdefault(id(eng), (eng, set()))[1]
            terms.update(int(t) for t in fl.terms)
        jobs: list[tuple[object, np.ndarray]] = []
        for eng, terms in per_eng.values():
            res = eng.resident          # one pool per engine
            pages = eng.span_pages(terms)
            missing = res.peek_missing(pages, cap=max(1, res.budget // 2))
            if missing.size:
                jobs.append((res, missing))
        if not jobs:
            return
        self._pf_jobs = jobs
        self._pf_results = [None] * len(jobs)

        def _gather(jobs=jobs, out=self._pf_results):
            t0 = time.perf_counter()
            for i, (res, pages) in enumerate(jobs):
                out[i] = res.store.gather(pages)
            self._pf_gather_s = time.perf_counter() - t0

        self._pf_thread = threading.Thread(target=_gather, daemon=True,
                                           name="repro-prefetch")
        self._pf_thread.start()

    def _join_prefetch(self) -> None:
        """Join the in-flight prefetch gather (if any) and admit its
        pages — the ONLY place prefetched data enters a pool, always on
        the main thread, always before the tick touches any slot."""
        if self._pf_thread is None:
            return
        t0 = time.perf_counter()
        self._pf_thread.join()
        waited = time.perf_counter() - t0
        self._pf_thread = None
        gathered = self._pf_gather_s
        self.prefetch_gather_ms += gathered * 1e3
        self.prefetch_join_wait_ms += waited * 1e3
        # the slice of the gather that ran while the main thread was
        # still dispatching — the fault stall the overlap removed
        self.overlap_ms += max(0.0, gathered - waited) * 1e3
        for (res, pages), staged in zip(self._pf_jobs, self._pf_results):
            if staged is None:
                continue
            syms, sums = staged
            self.prefetched_pages += res.admit_prefetched(pages, syms,
                                                          sums)
        self._pf_jobs = []
        self._pf_results = []

    def _advance(self, fl: _InFlight, value, *, start: bool = False) -> None:
        """Run one machine until it blocks on a ProbeRound (parked for the
        next merged dispatch) or returns (completed, out of order).  A
        machine that RAISES is retired before the error propagates — a
        poisoned query must not wedge the scheduler: everything else in
        flight keeps ticking on the next call."""
        with span("scheduler.advance", qid=fl.qid):
            self._run_machine(fl, value, start)

    def _run_machine(self, fl: _InFlight, value, start: bool) -> None:
        try:
            step = next(fl.machine) if start else fl.machine.send(value)
            while True:
                if isinstance(step, (ProbeRound, ScoreRound)):
                    fl.pending = step
                    return
                if isinstance(step, DecodeList):
                    res = self._decode(fl, step.t)
                else:                   # SetOp / PhraseShift: pure host
                    res = step.run()
                step = fl.machine.send(res)
        except StopIteration as stop:
            fl.done = True
            if isinstance(stop.value, RankedResult):
                rr: RankedResult = stop.value
                self.pages_scored += rr.pages_scored
                self.pages_skipped += rr.pages_skipped
                if rr.threshold > float("-inf"):
                    self.threshold_final = float(rr.threshold)
                if fl.key is not None and self.result_cache.maxsize > 0:
                    cached = rr.copy()
                    cached.docs.flags.writeable = False
                    cached.scores.flags.writeable = False
                    self.result_cache.put(fl.key, cached)
                self._finish(fl.qid, rr, fl.t0)
                return
            out = np.asarray(stop.value, dtype=np.int64)
            out = out if out.flags.writeable else out.copy()
            if fl.key is not None and self.result_cache.maxsize > 0:
                cached = out.copy()
                cached.flags.writeable = False
                self.result_cache.put(fl.key, cached)
            self._finish(fl.qid, out, fl.t0)
        except BaseException:
            # retire the poisoned query so the next tick filters it out
            # of _running instead of spinning on pending=None forever;
            # the error still reaches the caller (drain/search_many)
            fl.done = True
            self.failures += 1
            fl.machine.close()
            raise

    def _decode(self, fl: _InFlight, t: int) -> np.ndarray:
        """Serve a DecodeList step.  Deliberately two cache layers: this
        one is version-keyed per in-flight query and flushed by swap (the
        serving-correctness cache); the engine's own LRU underneath also
        serves the serial executor path and direct engine callers.  Both
        store references to the same frozen array, so the overlap costs a
        dict entry, not a copy."""
        key = (fl.version, int(t))
        arr = self.decode_cache.get(key)
        if arr is None:
            arr = fl.engine.decode_list(t)
            self.decode_cache.put(key, arr)
        return arr

    def _finish(self, qid: int, out: np.ndarray, t0: float) -> None:
        self._done[qid] = out
        self.completion_order.append(qid)
        now = time.perf_counter()
        self.latencies.append(now - t0)
        self._spans.append((t0, now))
        self._completed += 1

    # -- driving -------------------------------------------------------------

    def drain(self, max_ticks: int = 10_000_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0:
                return
        raise RuntimeError("scheduler failed to drain "
                           f"({len(self._running)} in flight)")

    def search_many(self, queries: Sequence,
                    force_algo: str | None = None) -> list[np.ndarray]:
        """Coalesced execution of a whole workload: submit everything,
        tick until drained, return results in SUBMIT order (completion
        order is recorded in ``completion_order``).  All-or-nothing on
        error: if any query raises, the whole batch is cancelled —
        queued/in-flight siblings are retired and completed results are
        released (``_done`` has no size bound, so an abandoned batch must
        not leak into it) — and the error propagates."""
        qids = [self.submit(q, force_algo) for q in queries]
        try:
            self.drain()
        except BaseException:
            self._cancel(set(qids))
            raise
        return [self.take(qid) for qid in qids]

    def search_topk_many(self, queries: Sequence, k: int = 10, *,
                         prune: bool = True) -> list[RankedResult]:
        """Coalesced ranked execution of a workload: page-decode rounds
        merge across the in-flight queries (and their membership probes
        merge with any boolean traffic).  Results in submit order; same
        all-or-nothing cancellation as :meth:`search_many`."""
        qids = [self.submit_topk(q, k, prune=prune) for q in queries]
        try:
            self.drain()
        except BaseException:
            self._cancel(set(qids))
            raise
        return [self.take(qid) for qid in qids]

    def search_topk(self, q, k: int = 10, *, prune: bool = True
                    ) -> RankedResult:
        return self.search_topk_many([q], k, prune=prune)[0]

    def _cancel(self, qids: set[int]) -> None:
        """Retire a batch: drop its queued/in-flight machines and release
        any results it already completed."""
        self._queue = deque(fl for fl in self._queue if fl.qid not in qids)
        for fl in self._running:
            if fl.qid in qids and not fl.done:
                fl.machine.close()
                fl.done = True
        self._running = [fl for fl in self._running if not fl.done]
        for qid in qids:
            self._done.pop(qid, None)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters: throughput, latency percentiles, and the
        coalescing factor (mean queries per merged dispatch — the direct
        measure of how much per-dispatch overhead the batcher amortizes).
        Percentiles and the coalescing factor cover the recent
        ``TELEMETRY_WINDOW``; ``completed``/``dispatches``/``failures``
        are cumulative."""
        lat = np.asarray(list(self.latencies), dtype=np.float64)
        widths = list(self._dispatch_widths)
        spans = list(self._spans)
        # windowed throughput: completions / (first submit -> last
        # completion) over the telemetry window, so idle gaps between
        # bursts do not dilute the number.  A single completion carries no
        # rate information (its span is just its own latency — for a
        # cached hit, microseconds, which once divided by reported
        # absurd qps) — so qps is defined only from two completions up,
        # and a degenerate elapsed guards the division.
        if len(spans) >= 2:
            elapsed = spans[-1][1] - spans[0][0]
            qps = (len(spans) / elapsed) if elapsed > 1e-9 else 0.0
        else:
            qps = 0.0
        lt = self._lane_totals
        memo_total = lt["memo_hits"] + lt["memo_misses"]
        return {
            "completed": self._completed,
            "failures": self.failures,
            "in_flight": len(self._running) + len(self._queue),
            "batch_window": self.batch_window,
            "qps": qps,
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "p95_ms": float(np.percentile(lat, 95) * 1e3) if lat.size else 0.0,
            "dispatches": self._dispatches,
            "merged_lanes": self._merged_lanes,
            # merged-round lane accounting (DESIGN.md §13.4): real lanes
            # are what queries asked for, unique lanes what survived
            # dedup, pad lanes the pow2 filler — reported separately so
            # no factor ever counts padding as work.  ``dedup_factor`` is
            # real work per dispatched unique lane; ``memo_hit_rate`` the
            # fraction of unique lanes served without touching a backend.
            "real_lanes": lt["real_lanes"],
            "unique_lanes": lt["unique_lanes"],
            "pad_lanes": lt["pad_lanes"],
            "dispatched_lanes": lt["dispatched_lanes"],
            "dedup_factor": (lt["real_lanes"] / lt["unique_lanes"]
                             if lt["unique_lanes"] else 0.0),
            "memo_hits": lt["memo_hits"],
            "memo_misses": lt["memo_misses"],
            "memo_hit_rate": (lt["memo_hits"] / memo_total
                              if memo_total else 0.0),
            "probe_memo": getattr(self._engine, "_probe_memo",
                                  LRUCache(0)).stats(),
            # overlapped prefetch (DESIGN.md §13.3)
            "prefetch_enabled": self.prefetch,
            "prefetched_pages": self.prefetched_pages,
            "prefetch_useful": self.prefetch_useful,
            "prefetch_accuracy": (self.prefetch_useful
                                  / max(self.prefetched_pages, 1)),
            "prefetch_gather_ms": self.prefetch_gather_ms,
            "prefetch_join_wait_ms": self.prefetch_join_wait_ms,
            "overlap_ms": self.overlap_ms,
            "pages_scored": self.pages_scored,
            "pages_skipped": self.pages_skipped,
            "pages_skipped_frac": (
                self.pages_skipped
                / max(self.pages_scored + self.pages_skipped, 1)),
            "threshold_final": float(self.threshold_final),
            "coalescing_factor": (float(np.mean(widths))
                                  if widths else 0.0),
            # per-codec device dispatch counts (DESIGN.md §10.3): a merged
            # (engine, algo) tick round splits inside the engine into one
            # device dispatch per codec present — the effective coalescing
            # key at the device boundary is (engine, codec, algo)
            "codec_dispatches": dict(
                getattr(self._engine, "codec_dispatches", {})),
            "decode_cache": self.decode_cache.stats(),
            "result_cache": self.result_cache.stats(),
            # the live engine's own decoded-list LRU (the layer under the
            # scheduler's decode cache) — hit rates for ALL caches
            "engine_decode_cache": getattr(self._engine, "_decoded",
                                           LRUCache(0)).stats(),
            # out-of-core admission cache (DESIGN.md §11.5): zeros when
            # the live engine serves fully resident
            **self._store_stats(),
            # streaming-ingestion telemetry (DESIGN.md §12): zeros when no
            # segmented manager is attached
            **(self.segmented.telemetry() if self.segmented is not None
               else {"segments": 0, "delta_docs": 0, "ingested_docs": 0,
                     "flushes": 0, "flush_ms": 0.0, "compactions": 0}),
        }

    def _store_stats(self) -> dict:
        resident = getattr(self._engine, "resident", None)
        if resident is None:
            return {"page_faults": 0, "page_evictions": 0,
                    "resident_pages": 0, "fault_bytes": 0,
                    "store_hit_rate": 0.0, "store": None}
        s = resident.stats()
        return {"page_faults": s["page_faults"],
                "page_evictions": s["page_evictions"],
                "resident_pages": s["resident_pages"],
                "fault_bytes": s["fault_bytes"],
                "store_hit_rate": s["hit_rate_window"],
                "store": s}
