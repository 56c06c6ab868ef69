"""Typed steps of the resumable query machine (DESIGN.md §8.1).

Lowering a physical plan (``QueryExecutor.lower``) yields a *step
machine*: a generator producing a sequence of typed steps, suspending at
each one until the driver sends the step's result back in.  The generator
frame is the continuation — a query can be parked indefinitely between
steps, which is what lets the serving scheduler interleave many queries
and coalesce their probe workloads into shared device dispatches
(``repro_torch.serve.scheduler``).

Five step types:

* :class:`ProbeRound`  — a pending batched ``next_geq`` workload as flat
  ``(list_ids, xs)`` arrays plus the algorithm ("svs" → bucket+skip
  probes, "bys" → compressed binary search).
* :class:`ScoreRound`  — a pending batched page-entry decode of a ranked
  top-k query (DESIGN.md §9.4): block-max page-entry ids whose documents
  the driver materializes through ``engine.dispatch_score_round``.
  ProbeRound and ScoreRound are the two steps that touch an engine, and
  both merge across queries in the serving scheduler.
* :class:`DecodeList`  — one whole-list expansion (merge/union/complement
  operands), served from the per-index decoded-list cache.
* :class:`SetOp`       — a host set-algebra combination of materialized
  operands (union / intersect / filter / complement).
* :class:`PhraseShift` — the positional-phrase host steps: shift
  candidate start positions to a term offset, or project surviving
  windows onto documents.

``SetOp``/``PhraseShift`` carry their whole computation in ``run()`` so
any driver — the serial one below, the coalescing scheduler, a test
harness — executes them identically; drivers only ever special-case the
two steps that need external data (ProbeRound, DecodeList).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import span

__all__ = ["ProbeRound", "ScoreRound", "DecodeList", "SetOp",
           "PhraseShift", "drive"]


@dataclasses.dataclass
class ProbeRound:
    """Pending ``next_geq`` probes of one suspended query.

    ``algo`` picks the engine primitive: ``"svs"`` routes to
    ``next_geq_batch`` (bucket lookup + phrase-sum skipping), ``"bys"``
    to ``next_geq_bys_batch`` (compressed binary search).  The driver
    answers with a ``(Q,)`` value array aligned with ``xs`` (``INT_INF``
    where no element >= x exists)."""

    list_ids: np.ndarray              # (Q,) int32 list ids
    xs: np.ndarray                    # (Q,) int32 probe values
    algo: str = "svs"                 # "svs" | "bys"
    #: route this round to a specific engine instead of the driver's
    #: default — the segmented index (DESIGN.md §12) tags every round
    #: with its segment's engine so multi-segment queries coalesce per
    #: (engine, algo) in the scheduler like any other traffic
    engine: object | None = None

    @property
    def size(self) -> int:
        return int(self.list_ids.size)


@dataclasses.dataclass
class ScoreRound:
    """Pending page-entry decodes of one suspended ranked query
    (DESIGN.md §9.4).  ``entries`` index the engine's
    :class:`~repro_torch.core.index.ScoreIndex` block-max directory; the
    driver answers with a ``(Q, B)`` int32 doc-id matrix (``INT_INF``
    padding past each entry's element count).  Elementwise in the entry
    lanes like ProbeRound, so the scheduler concatenates the ScoreRounds
    of all in-flight ranked queries into one merged decode dispatch."""

    entries: np.ndarray               # (Q,) int32 page-entry ids
    #: per-segment engine override, as on :class:`ProbeRound` — entry ids
    #: address THAT engine's block-max directory
    engine: object | None = None

    @property
    def size(self) -> int:
        return int(self.entries.size)


@dataclasses.dataclass
class DecodeList:
    """Request one whole list as a sorted int64 doc/position array."""

    t: int


@dataclasses.dataclass
class SetOp:
    """Host set-algebra step over materialized operands.

    ops: ``union`` (a ∪ b), ``intersect`` (a ∩ b, both unique-sorted),
    ``filter`` (a[b] for a boolean mask b), ``complement``
    ([0, domain) \\ a — ``b`` is the integer domain size)."""

    op: str
    a: np.ndarray
    b: np.ndarray | int | None = None

    def run(self) -> np.ndarray:
        with span("query.host_step", op=self.op):
            return self._run()

    def _run(self) -> np.ndarray:
        if self.op == "union":
            return np.union1d(self.a, self.b)
        if self.op == "intersect":
            return np.intersect1d(self.a, self.b, assume_unique=True)
        if self.op == "filter":
            return self.a[self.b]
        if self.op == "complement":
            return np.setdiff1d(np.arange(int(self.b), dtype=np.int64),
                                self.a, assume_unique=True)
        raise ValueError(f"unknown set op {self.op!r}")


@dataclasses.dataclass
class PhraseShift:
    """Host step of the positional-phrase pipeline.

    With ``stride=None``: shift candidate positions down by ``offset``
    (term offset → phrase-start positions) and drop the negatives.  With
    ``stride`` set: the finishing projection — drop windows of length
    ``k`` that straddle a document boundary and map survivors to doc
    ids."""

    positions: np.ndarray
    offset: int = 0
    stride: int | None = None
    k: int = 0

    def run(self) -> np.ndarray:
        with span("query.host_step",
                  op="shift" if self.stride is None else "project"):
            return self._run()

    def _run(self) -> np.ndarray:
        if self.stride is None:
            out = np.asarray(self.positions, np.int64) - int(self.offset)
            return out[out >= 0]
        pos = np.asarray(self.positions, np.int64)
        ok = (pos % self.stride) + self.k <= self.stride
        return np.unique(pos[ok] // self.stride)


def drive(machine, engine) -> np.ndarray:
    """Serial driver: run one step machine to completion on one engine.

    This is the single-query execution path (``QueryExecutor.run_plan``);
    the coalescing driver in ``repro_torch.serve.scheduler`` runs the same
    machines but parks them at :class:`ProbeRound` steps to merge
    workloads across queries.  ``ProbeRound`` dispatches through
    ``engine.dispatch_round`` so both drivers share the merged-round
    padding convention (DESIGN.md §8.2)."""
    try:
        step = next(machine)
        while True:
            if isinstance(step, ProbeRound):
                eng = step.engine if step.engine is not None else engine
                res = eng.dispatch_round(step.list_ids, step.xs, step.algo)
            elif isinstance(step, ScoreRound):
                eng = step.engine if step.engine is not None else engine
                res = eng.dispatch_score_round(step.entries)
            elif isinstance(step, DecodeList):
                res = engine.decode_list(step.t)
            else:
                res = step.run()
            step = machine.send(res)
    except StopIteration as stop:
        return stop.value
