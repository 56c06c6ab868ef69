"""The benchmark's corpus: a frozen copy of the port's ``zipf_corpus``.

``zipf_corpus`` draws the same documents as
``repro_torch.index.corpus.zipf_corpus`` for the same arguments (a test
holds the two together): Zipf word frequencies re-weighted by one of
``num_topics`` topics, topics assigned to contiguous runs of documents.
It consumes the generator's stream exactly as the original does; what
differs is only that each topic's cumulative distribution is computed
once instead of once a document (``Generator.choice`` with ``p`` and
``replace=True`` is a search of ``random()`` draws in that distribution),
and that ``postings`` inverts the documents in one sort.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def zipf_corpus(num_docs: int, vocab_size: int, mean_doc_len: int = 120,
                zipf_s: float = 1.3, num_topics: int = 20,
                topic_strength: float = 6.0, seed: int = 0
                ) -> list[np.ndarray]:
    """The sorted unique term ids of every document."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    base = ranks ** (-zipf_s)
    base /= base.sum()
    cdfs = []
    for _ in range(num_topics):
        sel = rng.choice(vocab_size, size=max(1, vocab_size // 25),
                         replace=False)
        m = np.ones(vocab_size)
        m[sel] *= topic_strength
        p = base * m
        p /= p.sum()
        cdf = p.cumsum()
        cdf /= cdf[-1]
        cdfs.append(cdf)
    doc_terms = []
    for d in range(num_docs):
        block_topic = (d * num_topics) // num_docs
        topic = (int(rng.integers(num_topics)) if rng.random() < 0.1
                 else block_topic)
        length = max(5, int(rng.poisson(mean_doc_len)))
        terms = cdfs[topic].searchsorted(rng.random(length), side="right")
        doc_terms.append(np.unique(terms).astype(np.int64))
    return doc_terms


def postings(doc_terms: list[np.ndarray]) -> list[np.ndarray]:
    """Per-term sorted doc-id lists, in ascending order of the terms that
    occur (a term in no document has no list)."""
    lens = np.fromiter((t.size for t in doc_terms), np.int64,
                       len(doc_terms))
    terms = np.concatenate(doc_terms) if doc_terms else np.empty(0, np.int64)
    docs = np.repeat(np.arange(len(doc_terms), dtype=np.int64), lens)
    order = np.argsort(terms, kind="stable")
    terms, docs = terms[order], docs[order]
    cut = np.flatnonzero(np.diff(terms)) + 1
    return np.split(docs, cut) if terms.size else []
