"""Query lowering over a :class:`~repro_torch.segment.manager.SegmentView`.

A copy of ``repro/segment/lowering.py`` (numpy) for the port.

One query = one step machine spanning every tier.  Per live segment the
UNCHANGED static-tier machines run (``QueryExecutor.lower`` for boolean,
``topk.lower_topk`` for ranked) against the segment's local term ids and
document domain; :func:`_drive_seg` forwards their engine-bound steps
upward **tagged with the segment's engine** so the scheduler coalesces
them per (engine, algo) like any other round, and answers ``DecodeList``
from the segment engine's own decode LRU (per-segment version keying —
the scheduler's shared decode cache is keyed on the SERVING index
version and must not see segment-local list ids).  The delta tier is
evaluated inline on host — it is uncompressed by design, so there is
nothing to dispatch.

Bit-identity with rebuild-from-scratch rests on two facts:

* segments + delta partition ``[0, total_docs)`` into contiguous ranges,
  so per-part boolean answers concatenate (already sorted) into exactly
  the global answer — including ``NOT`` via per-part complements;
* ranked scores are computed per part under the GLOBAL statistics with
  the one shared f32 reduction, so every document's score is bitwise the
  from-scratch score, and the global (score desc, doc asc) top-k is
  contained in the union of per-part top-k's — the final merge just
  re-sorts candidates it already has exact scores for.
"""

from __future__ import annotations

import numpy as np

from ..query.exec import naive_eval
from ..query.steps import DecodeList, ProbeRound, ScoreRound
from ..query.topk import RankedResult, lower_topk

__all__ = ["bool_machine", "topk_machine"]

_EMPTY = np.empty(0, np.int64)


def _drive_seg(machine, engine):
    """Run one static-tier step machine against ``engine``, forwarding
    only the steps the outer loop must see: ProbeRound/ScoreRound go
    upward tagged with the segment engine (so the serving scheduler
    merges them across queries AND segments), DecodeList is answered
    locally from the segment engine's LRU, host steps run inline."""
    try:
        step = next(machine)
        while True:
            if isinstance(step, (ProbeRound, ScoreRound)):
                step.engine = engine
                res = yield step
            elif isinstance(step, DecodeList):
                res = engine.decode_list(step.t)
            else:
                res = step.run()
            step = machine.send(res)
    except StopIteration as stop:
        return stop.value


class _DeltaLists:
    """Just enough sequence protocol for :func:`naive_eval`: ``len`` is
    the global vocabulary, ``[t]`` the delta-LOCAL doc ids of term ``t``
    (empty for terms the delta never saw)."""

    def __init__(self, dlists: dict[int, np.ndarray], num_terms: int):
        self._d = dlists
        self._n = int(num_terms)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, t: int) -> np.ndarray:
        return self._d.get(int(t), _EMPTY)


def bool_machine(view, node, force_algo):
    """Step machine of one boolean query over ``view``: per-segment
    static-tier machines + host evaluation of the delta, concatenated
    with each part's base offset."""
    def gen():
        parts: list[np.ndarray] = []
        for seg in view.segments:
            if seg.engine is None:
                # blank segment: owns its doc range but indexes nothing —
                # only complements can produce hits
                out = naive_eval(node, [], seg.num_docs)
            else:
                ex = seg.executor(force_algo)
                plan = ex.plan(seg.local_node(node))
                out = yield from _drive_seg(ex.lower(plan), seg.engine)
            out = np.asarray(out, np.int64)
            if out.size:
                parts.append(seg.base + out)
        if view.delta_docs:
            shim = _DeltaLists(view.delta_lists, view.num_terms)
            out = naive_eval(node, shim, view.delta_docs)
            if out.size:
                parts.append(view.delta_base + out)
        return np.concatenate(parts) if parts else _EMPTY.copy()
    return gen()


def _delta_scores(view, stats, ts):
    """Exact f32 BM25 of every delta document matching >= 1 query term:
    the SAME fixed reduction as ``accumulate_scores`` / ``rank_oracle``
    (ascending-term f32 idf sum, one f32 doc-weight multiply), evaluated
    densely over the delta range — so delta scores are bit-identical to
    what a from-scratch index would produce for these documents."""
    n = view.delta_docs
    acc = np.zeros(n, np.float32)
    hit = np.zeros(n, bool)
    for t in ts:                                  # ascending: fixed order
        ld = view.delta_lists.get(int(t))
        if ld is None:
            continue
        m = np.zeros(n, bool)
        m[ld] = True
        acc = acc + np.where(m, stats.idf[t], np.float32(0.0))
        hit |= m
    ldocs = np.flatnonzero(hit).astype(np.int64)
    gdocs = view.delta_base + ldocs
    scores = (stats.doc_w[gdocs] * acc[ldocs]).astype(np.float32)
    return gdocs, scores


def topk_machine(view, stats, ts, k, *, prune=True):
    """Step machine of one ranked top-k query over ``view`` under the
    global statistics ``stats``.  ``ts`` must be the cleaned ascending
    global term-id bag."""
    def gen():
        if k <= 0 or not ts:
            return RankedResult(np.empty(0, np.int64),
                                np.empty(0, np.float32))
        cd: list[np.ndarray] = []
        cs: list[np.ndarray] = []
        scored = skipped = 0
        for seg in view.segments:
            if seg.engine is None:
                continue
            lts = [lt for lt in (seg.local_term(t) for t in ts) if lt >= 0]
            if not lts:
                continue
            si = seg.score_si(stats)
            rr = yield from _drive_seg(lower_topk(si, lts, k, prune=prune),
                                       seg.engine)
            if rr.docs.size:
                cd.append(seg.base + rr.docs)
                cs.append(rr.scores)
            scored += rr.pages_scored
            skipped += rr.pages_skipped
        if view.delta_docs:
            gdocs, dscores = _delta_scores(view, stats, ts)
            if gdocs.size:
                cd.append(gdocs)
                cs.append(dscores)
        if not cd:
            return RankedResult(np.empty(0, np.int64),
                                np.empty(0, np.float32),
                                scored, skipped)
        docs = np.concatenate(cd)
        scores = np.concatenate(cs)
        order = np.lexsort((docs, -scores.astype(np.float64)))[:k]
        docs, scores = docs[order], scores[order]
        theta = float(scores[-1]) if docs.size == k else float("-inf")
        return RankedResult(docs, scores, scored, skipped, theta)
    return gen()
