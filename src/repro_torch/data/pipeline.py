"""Versioned postings feed of the port: ``PostingsSource``.

A copy of ``repro/data/pipeline.py::PostingsSource`` (numpy only; the
rest of that module, the LM token pipeline, is not ported).  It is the
versioned postings feed for the construction pipeline:
``lists_at(version)`` is a pure function of ``(seed, version)``, each
version extending the collection, so any builder host can recompute
exactly the snapshot it is asked to compress and a rebuilt index is
reproducible across machines.  ``QueryServer.rebuild`` consumes it in the
launcher's refresh loop.
"""

from __future__ import annotations

import numpy as np


class PostingsSource:
    """Deterministic, versioned, **append-only** postings feed for index
    build, refresh, and streaming ingestion.

    Every document is a pure function of ``(seed, doc_id)`` —
    ``doc_terms(d)`` keys its PRNG by the document id, never by the
    collection size or call order — so growing the collection NEVER
    rewrites an existing document.  That is the mutation-log contract the
    segment tier (DESIGN.md §12) replays: the whole feed is recomputable
    from one integer cursor (how many documents have been consumed), the
    same one-integer-resume shape as :class:`PipelineCursor`.

    ``lists_at(version)`` is a pure function of ``(seed, version)``:
    version ``v`` is the collection grown to
    ``base_docs + v * growth_docs`` documents.  ``deltas_at(version)``
    returns ONLY the documents version ``v`` added over ``v - 1`` — the
    refresh loop and the streaming ingest path consume that instead of
    recomputing the full corpus per version.
    """

    #: documents per topic block (fixed, so a doc's topic never depends
    #: on the total collection size — the append-only invariant)
    _TOPIC_BLOCK = 97
    _NUM_TOPICS = 20
    _ZIPF_S = 1.3
    _TOPIC_STRENGTH = 6.0

    def __init__(self, base_docs: int = 500, growth_docs: int = 250,
                 vocab: int = 2000, mean_doc_len: int = 80, seed: int = 0):
        self.base_docs = base_docs
        self.growth_docs = growth_docs
        self.vocab = vocab
        self.mean_doc_len = mean_doc_len
        self.seed = seed
        # per-topic sampling distributions, built once: Zipf base with a
        # boosted contiguous vocabulary band per topic
        base = np.arange(1, vocab + 1, dtype=np.float64) ** -self._ZIPF_S
        self._topic_p = []
        T = self._NUM_TOPICS
        for topic in range(T):
            p = base.copy()
            lo, hi = topic * vocab // T, (topic + 1) * vocab // T
            p[lo:hi] *= self._TOPIC_STRENGTH
            self._topic_p.append(p / p.sum())
        self._docs: list[np.ndarray] = []     # doc-id-indexed cache

    def num_docs_at(self, version: int) -> int:
        return self.base_docs + version * self.growth_docs

    def doc_terms(self, d: int) -> np.ndarray:
        """Sorted unique term ids of document ``d`` — pure in
        ``(seed, d)``; the unit the mutation log stores and replays."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x1E57, int(d)]))
        topic = (int(d) // self._TOPIC_BLOCK) % self._NUM_TOPICS
        if rng.random() < 0.1:                # topic drift
            topic = int(rng.integers(self._NUM_TOPICS))
        # vocabulary-introduction schedule: document ``d`` draws only from
        # the first ``vocab//2 + d`` terms — pure in ``d`` (the append-only
        # invariant holds), and a grown snapshot genuinely widens its term
        # universe instead of saturating the vocabulary at version 0
        acc = min(self.vocab, max(1, self.vocab // 2) + int(d))
        p = self._topic_p[topic][:acc]
        p = p / p.sum()
        n = min(acc, max(4, int(rng.poisson(self.mean_doc_len))))
        terms = rng.choice(acc, size=n, replace=False, p=p)
        return np.unique(terms.astype(np.int64))

    def docs_between(self, lo: int, hi: int) -> list[np.ndarray]:
        """Documents ``[lo, hi)`` (cached; generation is incremental)."""
        while len(self._docs) < hi:
            self._docs.append(self.doc_terms(len(self._docs)))
        return self._docs[lo:hi]

    def deltas_at(self, version: int) -> list[np.ndarray]:
        """ONLY the documents version ``version`` adds over the previous
        snapshot (the full base collection for version 0) — the segment
        tier's ingest feed and the refresh loop's incremental input."""
        lo = self.num_docs_at(version - 1) if version > 0 else 0
        return self.docs_between(lo, self.num_docs_at(version))

    def lists_at(self, version: int) -> tuple[list[np.ndarray], int]:
        """(postings lists, universe) of snapshot ``version`` — pure in
        (seed, version), so replays and cross-host builds are exact.
        Lists are dense over the terms PRESENT in the snapshot (same
        contract as ``SyntheticCorpus.postings``); because documents are
        append-only, snapshot ``v`` extends snapshot ``v - 1``."""
        n = self.num_docs_at(version)
        docs = self.docs_between(0, n)
        inv: dict[int, list[int]] = {}
        for d, terms in enumerate(docs):
            for t in terms.tolist():
                inv.setdefault(t, []).append(d)
        return [np.asarray(inv[t], np.int64) for t in sorted(inv)], n
