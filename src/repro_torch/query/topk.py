"""Ranked top-k retrieval with block-max page pruning (DESIGN.md §9).

The driver is a MaxScore/WAND hybrid lowered onto the same resumable
step-machine protocol as the boolean executor, so ranked queries ride the
coalescing scheduler unchanged:

* the candidate stream is the **block-max page directory** of the
  :class:`~repro_torch.core.index.ScoreIndex`: one entry per (query term,
  stream page), processed in descending upper-bound order — the
  best-first order makes the top-k threshold rise as fast as possible;
* a per-query **min-heap of (score, -doc)** lives in the generator frame
  (the heap-in-continuation design): the threshold θ it carries survives
  every suspension point, so pruning decisions straddle scheduler ticks
  for free;
* before each decode round every entry is admission-tested against the
  MIN of two independent upper bounds (each valid alone, so their min
  is too): the **doc-aligned block-max bound** ``page_ub + rest`` —
  ``rest`` sums, over the OTHER query terms, the max ``pg_ub`` among
  that term's entries whose [base, last] doc-id range overlaps this
  entry's (the BMW refinement of MaxScore: a term with no postings in
  the range contributes 0, not its global list max, so pages of a long
  list that don't co-range with the rare terms die the moment θ clears
  their own block max; a term whose every aligned bound falls below
  θ − page_ub is exactly a non-essential term, and the partition
  re-derives itself as θ rises — no partition state to maintain) —
  and the **doc-weight bound** ``page_wmax * Σ idf``: any document in
  the page scores at most its BM25 doc weight times the whole bag's
  idf mass, which prunes pages holding only long (heavily
  length-normalized) documents even while θ is far below the global
  maximum;
* surviving entries decode in one :class:`ScoreRound`; the fresh
  candidate documents are then membership-probed against ALL query terms
  in one :class:`ProbeRound` ("svs" lanes — these merge with boolean
  traffic in the scheduler), and exact float32 scores come from the one
  shared reduction (``accumulate_scores``).

Pruning safety under float32 quantization (§9.2): ``pg_ub`` maxes
already-rounded float32 products, so it upper-bounds every float32
single-term contribution exactly; the float64 admission bound then only
has to absorb float32 *accumulation* error, which ``SLACK`` = 1 + 1e-5
over-covers by ~3 orders of magnitude for any plausible bag width (K
adds ⇒ relative error ≤ (K+1)·2⁻²³ ≈ 4e-6 at K = 32).  The comparison
is STRICT, so a page whose true best exactly ties θ is never skipped and
doc-id tie-breaking stays exact.

The brute-force oracle (``rank_oracle``) scores every document of the raw
lists with the same float32 reduction — the differential gate
(tests/test_topk.py) holds every backend to exact score AND order
equality against it, pruned and exhaustive.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..core.index import (BM25_B, BM25_K1, INT_INF, ScoreIndex,
                              accumulate_scores, bm25_doc_weights, bm25_idf)
from .steps import ProbeRound, ScoreRound, drive

__all__ = ["RankedResult", "lower_topk", "search_topk", "rank_oracle",
           "SLACK", "CHUNK_PAGES"]

#: float64 admission-bound slack absorbing float32 accumulation error
SLACK = 1.0 + 1e-5

#: page entries admitted per ScoreRound: batches device decodes (and
#: scheduler ticks) without letting θ go stale — θ is re-read between
#: chunks, and over-admitting never affects correctness, only work.
#: While the heap is still filling, chunks additionally close as soon as
#: the admitted entries carry enough elements to fill it, so θ exists
#: before the bulk of the page stream is admitted blind.
CHUNK_PAGES = 8


@dataclasses.dataclass
class RankedResult:
    """One ranked answer: documents in (score desc, doc asc) order with
    their exact float32 scores, plus the pruning telemetry the serving
    counters aggregate (``threshold`` is -inf if the heap never filled)."""

    docs: np.ndarray                  # (<=k,) int64
    scores: np.ndarray                # (<=k,) float32, aligned
    pages_scored: int = 0
    pages_skipped: int = 0
    threshold: float = float("-inf")

    def copy(self) -> "RankedResult":
        return RankedResult(self.docs.copy(), self.scores.copy(),
                            self.pages_scored, self.pages_skipped,
                            self.threshold)


def _clean_terms(terms, vocab: int) -> list[int]:
    """Dedupe, drop out-of-vocabulary ids, sort ascending — the fixed
    accumulation order every scoring path shares."""
    return sorted({int(t) for t in terms if 0 <= int(t) < vocab})


def lower_topk(si: ScoreIndex, terms, k: int, *, prune: bool = True,
               chunk_pages: int = CHUNK_PAGES):
    """Step machine of one ranked top-k query (generator — drive it with
    ``steps.drive`` or park it on the scheduler).  Returns a
    :class:`RankedResult`; ``prune=False`` scores every page (the
    exhaustive baseline the benchmark compares pages-touched against)."""
    k = int(k)
    ts = _clean_terms(terms, int(si.idf.shape[0]))
    if k <= 0 or not ts:
        return RankedResult(np.empty(0, np.int64), np.empty(0, np.float32))

    tarr = np.asarray(ts, np.int64)
    K = tarr.size
    spans = [(int(si.page_off[t]), int(si.page_off[t + 1])) for t in ts]
    ebyt = [np.arange(l, h) for l, h in spans]
    eids = (np.concatenate(ebyt) if any(h > l for l, h in spans)
            else np.empty(0, np.int64))
    ubs = si.pg_ub[eids].astype(np.float64)
    # doc-aligned Block-Max rest: for every entry, each OTHER term adds
    # at most the max pg_ub among ITS entries whose [base, last] doc
    # range overlaps this entry's — a term with no postings in the range
    # contributes 0 (vs its global list max under plain MaxScore), which
    # is where binary-tf BM25 actually earns its skips
    rest = np.zeros(eids.size, np.float64)
    offs = np.concatenate([[0], np.cumsum([h - l for l, h in spans])])
    for a in range(K):
        ea = ebyt[a]
        if not ea.size:
            continue
        alo = si.pg_base[ea].astype(np.int64)
        ahi = si.pg_last[ea].astype(np.int64)
        for bq in range(K):
            eb = ebyt[bq]
            if bq == a or not eb.size:
                continue
            blo = si.pg_base[eb].astype(np.int64)   # ascending per term
            bhi = si.pg_last[eb].astype(np.int64)
            bub = si.pg_ub[eb].astype(np.float64)
            i0 = np.searchsorted(bhi, alo, "left")
            i1 = np.searchsorted(blo, ahi, "right")
            for j in range(ea.size):
                if i1[j] > i0[j]:
                    rest[offs[a] + j] += bub[i0[j]:i1[j]].max()
    idf_total = si.idf[tarr].astype(np.float64).sum()
    bound = np.minimum(ubs + rest,                  # aligned block-max bound
                       si.pg_wmax[eids].astype(np.float64) * idf_total
                       ) * SLACK                    # f64 admission bound
    order = np.lexsort((eids, -ubs))               # ub desc, entry id asc

    heap: list[tuple[float, int]] = []             # (score, -doc) min-heap
    seen: set[int] = set()
    scored = skipped = 0
    theta = float("-inf")
    i, E = 0, order.size
    while i < E:
        batch: list[int] = []
        admitted = 0
        while i < E and len(batch) < chunk_pages:
            e = order[i]
            i += 1
            if prune and len(heap) == k and bound[e] < theta:
                skipped += 1
                continue
            batch.append(int(eids[e]))
            admitted += int(si.pg_count[eids[e]])
            if len(heap) < k and admitted >= max(k, 16):
                break      # enough to fill the heap — set θ early
        if not batch:
            continue
        mat = np.asarray((yield ScoreRound(np.asarray(batch, np.int32))))
        scored += len(batch)
        docs = np.unique(mat[mat != int(INT_INF)].astype(np.int64))
        fresh = np.asarray([d for d in docs.tolist() if d not in seen],
                           np.int64)
        if not fresh.size:
            continue
        seen.update(fresh.tolist())
        # one merged membership round: every candidate against every term
        lids = np.repeat(tarr, fresh.size).astype(np.int32)
        xs = np.tile(fresh, K).astype(np.int32)
        vals = yield ProbeRound(lids, xs, "svs")
        member = (np.asarray(vals, np.int64).reshape(K, fresh.size)
                  == fresh)
        scores = accumulate_scores(si, tarr, member, fresh)
        for d, s in zip(fresh.tolist(), scores.tolist()):
            item = (s, -d)                # worst = (lowest score, highest doc)
            if len(heap) < k:
                heapq.heappush(heap, item)
            elif item > heap[0]:
                heapq.heapreplace(heap, item)
        if len(heap) == k:
            theta = heap[0][0]
    ranked = sorted(heap, key=lambda it: (-it[0], -it[1]))
    return RankedResult(np.asarray([-nd for _, nd in ranked], np.int64),
                        np.asarray([s for s, _ in ranked], np.float32),
                        scored, skipped, theta)


def search_topk(engine, terms, k: int, *, prune: bool = True,
                chunk_pages: int = CHUNK_PAGES) -> RankedResult:
    """Serial ranked top-k on one engine (the single-query path; the
    serving path parks the same machine on the scheduler)."""
    return drive(lower_topk(engine.score_index, terms, k, prune=prune,
                            chunk_pages=chunk_pages), engine)


def rank_oracle(lists, universe: int, terms, k: int, *,
                k1: float = BM25_K1, b: float = BM25_B
                ) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force score-everything oracle over the RAW posting lists:
    no index, no pruning — every document of every query term is scored
    with the same float32 reduction the engines use, then ranked by
    (score desc, doc asc).  Returns ``(docs, scores)`` of the top k."""
    vocab = len(lists)
    ts = _clean_terms(terms, vocab)
    dl = np.zeros(max(1, int(universe)), np.int64)
    for lst in lists:
        dl[np.asarray(lst, np.int64)] += 1
    ndocs = int((dl > 0).sum())
    avgdl = float(dl.sum() / max(ndocs, 1))
    idf = bm25_idf(np.asarray([len(lst) for lst in lists], np.int64), ndocs)
    doc_w = bm25_doc_weights(dl, avgdl, k1, b)
    acc = np.zeros(dl.size, np.float32)
    hit = np.zeros(dl.size, bool)
    for t in ts:                        # ascending ids: the fixed order
        m = np.zeros(dl.size, bool)
        m[np.asarray(lists[t], np.int64)] = True
        acc = acc + np.where(m, idf[t], np.float32(0.0))
        hit |= m
    scores = (doc_w * acc).astype(np.float32)
    docs = np.flatnonzero(hit).astype(np.int64)
    order = np.lexsort((docs, -scores[docs].astype(np.float64)))
    top = docs[order[:max(0, int(k))]]
    return top, scores[top]
