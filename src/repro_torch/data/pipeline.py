"""Deterministic, sharded, resumable data feeds of the port: a copy of
``repro/data/pipeline.py`` (numpy only).

* the LM token pipeline: ``DataConfig``, ``PipelineCursor``,
  ``SyntheticLMDataset`` and ``ShardedTokenPipeline``.  Every host pulls
  only its shard of the global batch; the order is a pure function of
  ``(seed, step)``, so a restarted host recomputes exactly its stream,
  the cursor is one integer (``step``) that lives inside the checkpoint,
  and an elastic rescale changes only ``shard_id / num_shards`` (batches
  are built globally and sliced per shard).  The batches equal the
  reference's bit for bit.
* ``PostingsSource``: the versioned postings feed for the construction
  pipeline.  ``lists_at(version)`` is a pure function of ``(seed,
  version)``, each version extending the collection, so any builder host
  can recompute exactly the snapshot it is asked to compress and a
  rebuilt index is reproducible across machines.  ``QueryServer.rebuild``
  consumes it in the launcher's refresh loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0


@dataclasses.dataclass
class PipelineCursor:
    """The full pipeline state: one integer.  Stored in every checkpoint."""
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": int(self.step)}

    @staticmethod
    def from_dict(d: dict) -> "PipelineCursor":
        return PipelineCursor(step=int(d["step"]))


class SyntheticLMDataset:
    """Deterministic synthetic packed-token stream.

    ``batch_at(step)`` is a pure function: the PRNG is keyed by
    (seed, step), never by call order, so replays are exact.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        tokens = rng.integers(
            0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1),
            dtype=np.int32)
        # Inject learnable structure: token t+1 depends on token t for a
        # slice of positions, so loss actually decreases in examples.
        dep = (tokens[:, :-1] * 31 + 7) % cfg.vocab
        mask = rng.random((cfg.global_batch, cfg.seq_len)) < 0.5
        tokens[:, 1:][mask] = dep[mask]
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


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


class ShardedTokenPipeline:
    """Per-host view of the global stream + resumable cursor."""

    def __init__(self, dataset: SyntheticLMDataset, shard_id: int = 0,
                 num_shards: int = 1, cursor: PipelineCursor | None = None):
        assert 0 <= shard_id < num_shards
        gb = dataset.cfg.global_batch
        assert gb % num_shards == 0, (
            f"global_batch {gb} must divide over {num_shards} shards")
        self.dataset = dataset
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.cursor = cursor or PipelineCursor()

    @property
    def local_batch(self) -> int:
        return self.dataset.cfg.global_batch // self.num_shards

    def next_batch(self) -> dict[str, np.ndarray]:
        """The shard's slice of the global batch at the cursor; advances."""
        full = self.dataset.batch_at(self.cursor.step)
        lo = self.shard_id * self.local_batch
        hi = lo + self.local_batch
        self.cursor.step += 1
        return {k: v[lo:hi] for k, v in full.items()}

    def state_dict(self) -> dict:
        return self.cursor.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.cursor = PipelineCursor.from_dict(d)
