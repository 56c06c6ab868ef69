"""Batched query serving over the device-resident Re-Pair index.

The port of ``repro/serve/query_serve.py::QueryServer``.  The server:

* keeps the index tensors resident on one device (``device``, default
  ``"cuda"``; ``"cpu"`` runs the plain versions),
* routes EVERY query through the backend-pluggable engine API
  (``repro_torch.engine``): 2-term AND batches via ``intersect_pairs``,
  k-term conjunctions via ``intersect_multi``, point probes via
  ``member_batch``;
* lets the engine fall back to the host path for degenerate cases (very
  long "short" lists), as a real tier routes outliers.

Pick the backend at construction: ``engine="cuda"`` (default: the
``list_intersect`` and ``page_score`` kernels), ``"torch"`` (plain
PyTorch programs, flat or ``paged=True``), or ``"host"`` (CPU
reference).  ``page_size`` sets the paged stream layout.

Boolean queries run on the
:class:`~repro_torch.serve.scheduler.QueryScheduler`: ``submit`` /
``search_many`` coalesce the probe rounds of all in-flight queries into
shared device dispatches; the single-query ``search`` is a one-entry
scheduler run, so there is exactly one execution path.  Ranked BM25
top-k (``search_topk``) runs on the same scheduler with block-max page
pruning.  ``swap_index(res)`` replaces the served index without a
restart and bumps the index version that keys every cache.

Not ported yet: ``mesh`` sharding, ``rebuild`` and the device builders,
the codec tier, the page store and streaming ingestion.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.index import DEFAULT_PAGE
from ..core.repair import RePairResult
from ..engine import make_engine
from ..kernels import resolve_device
from ..query import Node, PlanNode, QueryExecutor
from ..query.plan import explain as explain_plan
from .scheduler import QueryScheduler


class QueryServer:
    def __init__(self, res: RePairResult, max_short_len: int = 256,
                 B: int = 8, engine: str = "cuda", device="cuda",
                 page_size: int = DEFAULT_PAGE, paged: bool = False,
                 batch_window: int | None = None):
        self._engine_name = engine
        kwargs: dict = {}
        if engine in ("torch", "cuda"):
            kwargs.update(max_short_len=max_short_len, B=B,
                          page_size=page_size,
                          device=resolve_device(device))
            if engine == "torch":
                kwargs["paged"] = paged
        self._engine_kwargs = kwargs
        self._batch_window = batch_window
        self._scheduler: QueryScheduler | None = None
        self.version = -1               # first swap_index brings it to 0
        self.swap_index(res)

    # -- hot swap -------------------------------------------------------------

    def swap_index(self, res: RePairResult) -> None:
        """Atomically replace the served index: the new engine (and its
        device tensors) is built COMPLETELY before the single reference
        swap, so serving never observes a half-built index.  Bumps the
        index version and flushes the scheduler's per-index caches;
        queries already in flight finish on the old engine."""
        engine = make_engine(self._engine_name, res, **self._engine_kwargs)
        self.version += 1
        engine.index_version = self.version
        self.res, self.engine = res, engine
        self._executor = None   # planner stats are per-index
        if self._scheduler is not None:
            self._scheduler.swap(engine, self.version)

    # -- batched API ----------------------------------------------------------

    def member_batch(self, list_ids: np.ndarray, xs: np.ndarray) -> np.ndarray:
        return np.asarray(self.engine.member_batch(
            np.asarray(list_ids, np.int32), np.asarray(xs, np.int32)))

    def next_geq_batch(self, list_ids: np.ndarray,
                       xs: np.ndarray) -> np.ndarray:
        return self.engine.next_geq_batch(
            np.asarray(list_ids, np.int32), np.asarray(xs, np.int32))

    def and_batch(self, pairs: Sequence[tuple[int, int]]
                  ) -> list[np.ndarray]:
        """Batch of conjunctive (term_i AND term_j) queries."""
        return self.engine.intersect_pairs(pairs)

    def and_multi(self, queries: Sequence[Sequence[int]]
                  ) -> list[np.ndarray]:
        """Batch of k-term conjunctive queries (arbitrary k >= 1 per query):
        each runs as device-side pairwise svs, shortest list first by
        uncompressed length — the [BLOL06] order the paper adopts in §3.3."""
        return [self.engine.intersect_multi(list(q)) for q in queries]

    # -- boolean queries (planner + scheduler) --------------------------------

    @property
    def scheduler(self) -> QueryScheduler:
        """The cross-query batching runtime (admission queue +
        microbatcher), bound lazily to the live engine and rebound with
        flushed caches at every index swap."""
        if self._scheduler is None:
            self._scheduler = QueryScheduler(
                self.engine, batch_window=self._batch_window,
                version=self.version)
        return self._scheduler

    @property
    def executor(self) -> QueryExecutor:
        """Cost-based boolean planner bound to the live engine; rebuilt on
        every index swap.  Shares the scheduler's default executor so
        planner statistics are derived once per index."""
        if self._executor is None:
            self._executor = self.scheduler._executor(None)
        return self._executor

    def submit(self, q: str | Node, force_algo: str | None = None) -> int:
        """Enqueue a boolean query on the scheduler; returns its query id
        (``scheduler.take(qid)`` after ticking/draining)."""
        return self.scheduler.submit(q, force_algo)

    def search_many(self, queries: Sequence,
                    force_algo: str | None = None) -> list[np.ndarray]:
        """Coalesced execution of a query batch: all in-flight probe
        rounds merge into shared device dispatches; results come back in
        submit order."""
        return self.scheduler.search_many(queries, force_algo)

    def search(self, q: str | Node,
               force_algo: str | None = None) -> np.ndarray:
        """Evaluate a boolean query — an AST node or a query string like
        ``'(12 AND 40) OR NOT 7'`` — through the planner + engine seam.
        ``force_algo`` pins every conjunctive step ("merge"/"svs"/"bys"/
        "meld"); default lets the cost model choose per step."""
        return self.scheduler.search_many([q], force_algo)[0]

    # -- ranked retrieval -----------------------------------------------------

    def submit_topk(self, q, k: int = 10, *, prune: bool = True) -> int:
        """Enqueue a ranked top-k query (query string, AST node, or term
        id sequence — only the term bag matters)."""
        return self.scheduler.submit_topk(q, k, prune=prune)

    def search_topk_many(self, queries: Sequence, k: int = 10, *,
                         prune: bool = True):
        """Coalesced ranked execution: the block-max page decodes of all
        in-flight queries merge into shared ScoreRound dispatches, their
        membership probes into the boolean probe groups."""
        return self.scheduler.search_topk_many(queries, k, prune=prune)

    def search_topk(self, q, k: int = 10, *, prune: bool = True):
        """BM25 top-k through the serving runtime (block-max pruned by
        default; ``prune=False`` scores every page — same ranking, more
        pages touched)."""
        return self.scheduler.search_topk(q, k, prune=prune)

    def serve_stats(self) -> dict:
        """Scheduler counters: qps, latency percentiles, coalescing
        factor, cache hit rates, and the ranked-retrieval pruning
        counters (pages scored/skipped, last final threshold)."""
        return self.scheduler.stats()

    def plan(self, q: str | Node) -> PlanNode:
        return self.executor.plan(q)

    def explain(self, q: str | Node) -> str:
        """Human-readable physical plan for a query."""
        return explain_plan(self.executor.plan(q))
