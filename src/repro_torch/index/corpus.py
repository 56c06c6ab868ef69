"""Synthetic text-collection generator.

The paper indexes TREC-4 FT91-94 (495.5 MB, 210,138 documents, 502,259
words, 50.3M postings).  That collection is not available offline, so we
synthesize collections with the two statistical properties the paper's
§5.1 analysis identifies as the sources of Re-Pair compressibility:

1. **Zipf word frequencies** [Zip49] — the main driver ("it can be largely
   explained by combinatorial arguments and by the distribution of the list
   lengths.  This is governed by Zipf Law").
2. **Positive word-document correlation** [BYN04] — the secondary driver
   (words co-occurring in documents create repeated d-gap pairs; the paper
   quantifies it at ~25% extra compression vs randomized lists).

We model (2) with topic mixtures: each document draws a topic, each topic
re-weights a subset of the vocabulary, so topical words cluster in the same
documents and generate repeated gap patterns.

``pack_documents`` reproduces the paper's doc-packing experiment (§5.1 "We
packed 1 to 128 consecutive documents").  ``randomize_lists`` reproduces the
random-list control (§5.1: each list replaced by equally many uniform ids).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    num_docs: int
    vocab_size: int
    doc_terms: list[np.ndarray]          # sorted unique term ids per doc

    def postings(self) -> list[np.ndarray]:
        """Invert: per-term sorted doc-id lists (document-level index)."""
        term_docs: dict[int, list[int]] = {}
        for d, terms in enumerate(self.doc_terms):
            for t in terms:
                term_docs.setdefault(int(t), []).append(d)
        lists = []
        self.term_ids = np.asarray(sorted(term_docs.keys()), dtype=np.int64)
        for t in self.term_ids:
            lists.append(np.asarray(term_docs[int(t)], dtype=np.int64))
        return lists


def zipf_corpus(
    num_docs: int = 2000,
    vocab_size: int = 5000,
    mean_doc_len: int = 120,
    zipf_s: float = 1.3,
    num_topics: int = 20,
    topic_strength: float = 6.0,
    seed: int = 0,
) -> SyntheticCorpus:
    """Zipf-distributed vocabulary with topic-correlated documents."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    base = ranks ** (-zipf_s)
    base /= base.sum()

    # Each topic boosts a random 4% slice of the vocabulary.  Topics are
    # assigned to CONTIGUOUS runs of documents (news arrives in topical /
    # temporal bursts [BYN04]) — this is what creates repeated d-gap pairs
    # across the lists of co-occurring words, the correlation source the
    # paper quantifies at ~25% extra compression vs randomized lists.
    topic_masks = []
    for _ in range(num_topics):
        sel = rng.choice(vocab_size, size=max(1, vocab_size // 25),
                         replace=False)
        m = np.ones(vocab_size)
        m[sel] *= topic_strength
        topic_masks.append(m)

    doc_terms: list[np.ndarray] = []
    for d in range(num_docs):
        block_topic = (d * num_topics) // num_docs    # contiguous runs
        topic = (int(rng.integers(num_topics)) if rng.random() < 0.1
                 else block_topic)
        p = base * topic_masks[topic]
        p /= p.sum()
        length = max(5, int(rng.poisson(mean_doc_len)))
        terms = rng.choice(vocab_size, size=length, replace=True, p=p)
        doc_terms.append(np.unique(terms).astype(np.int64))
    return SyntheticCorpus(num_docs=num_docs, vocab_size=vocab_size,
                           doc_terms=doc_terms)


def pack_documents(corpus: SyntheticCorpus, pack: int) -> SyntheticCorpus:
    """Merge every ``pack`` consecutive documents into one (paper §5.1's
    larger-documents scenario, e.g. pack=10)."""
    new_docs: list[np.ndarray] = []
    for i in range(0, corpus.num_docs, pack):
        merged = np.unique(np.concatenate(corpus.doc_terms[i:i + pack]))
        new_docs.append(merged)
    return SyntheticCorpus(num_docs=len(new_docs),
                           vocab_size=corpus.vocab_size, doc_terms=new_docs)


def randomize_lists(lists: list[np.ndarray], universe: int,
                    seed: int = 0) -> list[np.ndarray]:
    """Paper §5.1 control: keep each list's length, destroy document
    skewness by replacing its entries with uniform random distinct ids."""
    rng = np.random.default_rng(seed)
    out = []
    for pl in lists:
        out.append(np.sort(rng.choice(universe, size=len(pl), replace=False)))
    return out
