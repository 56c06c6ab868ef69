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
``list_intersect``, ``ef_next_geq`` and ``page_score`` kernels),
``"torch"`` (plain PyTorch programs, flat or ``paged=True``), or
``"host"`` (CPU reference).  ``page_size`` sets the paged stream layout
(on the host engine, only the page store's fault granularity).
``codec`` selects the per-list codec tier: ``"repair"`` (default),
``"ef"`` / ``"bitmap"`` (forced), ``"adaptive"`` (cost-model choice per
list), or None to honour ``REPRO_CODEC``; every engine the server builds
gets it, and ``swap_index`` re-runs codec selection over the new index.

Boolean queries run on the
:class:`~repro_torch.serve.scheduler.QueryScheduler`: ``submit`` /
``search_many`` coalesce the probe rounds of all in-flight queries into
shared device dispatches; the single-query ``search`` is a one-entry
scheduler run, so there is exactly one execution path.  Ranked BM25
top-k (``search_topk``) runs on the same scheduler with block-max page
pruning.  ``swap_index(res)`` replaces the served index without a
restart and bumps the index version that keys every cache.

**Index refresh without restarting**: ``rebuild(lists)`` compresses a new
postings snapshot through the backend-pluggable build subsystem
(``repro_torch.build``, default the ``torch`` builder, on the server's
device), stands up a complete replacement engine off to the side, and
swaps it in with one reference assignment — queries in flight on the old
engine finish on the old index, the next batch sees the new one.

**Out of core**: ``store`` (``"memory"`` / ``"mmap"``, or None to
honour ``REPRO_STORE``) puts the compressed stream behind a page store,
served through a bounded admission cache of ``resident_pages`` pages
(None honours ``REPRO_RESIDENT_PAGES``; unset means every page).  Every
``swap_index`` builds a FRESH store and resident pool for the new engine,
so the version pin extends to the page cache: in-flight queries hold the
old engine, hence the old pool.

**Streaming ingestion**: ``enable_ingest`` attaches a segmented
log-structured index (:mod:`repro_torch.segment`) over the live engine:
``insert(doc)`` is visible to the next query, the delta flushes into
immutable Re-Pair segments past ``delta_budget`` documents, and the
scheduler runs one compaction step per tick.  Every segment engine is
made with the serving engine's own construction knobs, so on the card
each segment is served by the same kernels, on the same device.

**List-sharded serving**: ``mesh`` (a
:class:`~repro_torch.distributed.Mesh`, the devices of its ``data``
axis) shards the Re-Pair probe rounds of the torch and cuda engines over
the mesh's devices (replicated grammar, list-partitioned stream, a max
across the shards); the host engine ignores it, as in ``repro``.  Every engine the server makes —
``swap_index``, ``rebuild``, every segment under ingest — is sharded the
same way, each over its own index.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..build import BuildConfig, Builder, make_builder
from ..core.index import DEFAULT_PAGE
from ..core.repair import RePairResult
from ..distributed import Mesh
from ..engine import Engine, make_engine
from ..kernels import resolve_device
from ..query import Node, PlanNode, QueryExecutor
from ..query.plan import explain as explain_plan
from .scheduler import QueryScheduler


class QueryServer:
    def __init__(self, res: RePairResult, max_short_len: int = 256,
                 B: int = 8, engine: str = "cuda", device="cuda",
                 page_size: int = DEFAULT_PAGE, paged: bool = False,
                 batch_window: int | None = None,
                 codec: str | None = None,
                 store: str | None = None,
                 resident_pages: int | None = None,
                 mesh: Mesh | None = None):
        self._engine_name = engine
        #: where rebuild() runs a device builder named by string
        self._device = device
        # engine construction parameters, kept so every swap_index and
        # rebuild stands up an identical engine (and a fresh store + pool)
        # over the new index
        kwargs: dict = {"codec": codec, "store": store,
                        "resident_pages": resident_pages,
                        "page_size": page_size}
        if engine in ("torch", "cuda"):
            self._device = resolve_device(device)
            kwargs.update(max_short_len=max_short_len, B=B,
                          device=self._device, mesh=mesh)
            if engine == "torch":
                kwargs["paged"] = paged
        self._engine_kwargs = kwargs
        self._batch_window = batch_window
        self._scheduler: QueryScheduler | None = None
        self._segmented = None
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
        # a segmented manager wraps the OLD engine as its base segment —
        # a full-index swap supersedes it (call enable_ingest again to
        # resume streaming on the new index)
        self._segmented = None
        if self._scheduler is not None:
            self._scheduler.swap(engine, self.version)

    def rebuild(self, lists: Sequence[np.ndarray], *,
                builder: str | Builder = "torch",
                build_cfg: BuildConfig | None = None) -> RePairResult:
        """Compress a new postings snapshot and hot-swap it in; returns the
        new compressed result.  A builder named by string runs on the
        server's device (the card unless the server was given
        ``device="cpu"``); a :class:`Builder` instance runs where it was
        made."""
        if not isinstance(builder, Builder):
            builder = make_builder(builder, build_cfg, device=self._device)
        res = builder.build_grammar(lists)
        self.swap_index(res)
        return res

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

    # -- streaming ingestion -------------------------------------------------

    def _segment_engine(self, res: RePairResult) -> Engine:
        """Engine factory for flushed and compacted segments: the SAME
        backend and construction knobs as the serving engine (device,
        codec tier, page size, mesh, out-of-core store), so every segment
        gets its own decode LRU and, out of core, its own page store and
        resident pool."""
        return make_engine(self._engine_name, res, **self._engine_kwargs)

    def enable_ingest(self, *, delta_budget: int | None = None,
                      builder: str | Builder = "host",
                      build_cfg: BuildConfig | None = None,
                      compact_fanout: int | None = None):
        """Attach a segmented log-structured index over the live engine
        and route queries through it: ``insert(doc)`` becomes visible to
        the next submitted query, the delta flushes into immutable
        Re-Pair segments past ``delta_budget`` documents
        (``REPRO_DELTA_BUDGET``), and the scheduler runs one generational
        compaction step per tick in the background.  A builder named by
        string runs on the server's device.  Idempotent; a subsequent
        ``swap_index``/``rebuild`` detaches it."""
        if self._segmented is None:
            from ..segment import SegmentedIndex
            if not isinstance(builder, Builder):
                builder = make_builder(builder, build_cfg,
                                       device=self._device)
            self._segmented = SegmentedIndex(
                self.res, self.engine, self._segment_engine,
                builder=builder, delta_budget=delta_budget,
                compact_fanout=compact_fanout)
            self.scheduler.segmented = self._segmented
        return self._segmented

    @property
    def segmented(self):
        """The attached segment manager, or None outside ingest mode."""
        return self._segmented

    def insert(self, terms) -> int:
        """Insert one document (its sorted unique term ids); returns the
        global doc id.  Enables ingest mode on first use."""
        if self._segmented is None:
            self.enable_ingest()
        return self._segmented.insert(terms)

    def flush(self):
        """Force the delta tier into an immutable segment now (normally
        budget-triggered); returns the new segment, or None if empty."""
        if self._segmented is None:
            return None
        return self._segmented.flush()

    def compact(self) -> int:
        """Run generational compaction to quiescence (normally the
        scheduler amortizes one step per tick); returns steps merged."""
        if self._segmented is None:
            return 0
        return self._segmented.compact()

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
