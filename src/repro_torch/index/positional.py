"""Positional inverted index: phrase queries by position-list intersection.

Paper §1: "In order to support phrase queries at the index level, the
inverted index must store all the positions where each word appears in
each document.  Then phrase queries can be solved essentially by
intersecting word positions.  The same opportunities for smart
intersection arise."

We realize exactly that: each term's postings are its absolute token
positions (doc_id · stride + offset, with stride > max document length so
positions never cross documents).  The position lists are strictly
increasing integer lists — the same object the rest of the system
compresses — so they go through Re-Pair + sampling unchanged, and a
phrase "a b" is ``positions(a) ∩ (positions(b) - 1)`` computed with ANY
of the §3.3 intersection algorithms over the compressed lists.

Position lists are longer and have smaller, more repetitive gaps than
document lists — the regime where Re-Pair shines (§5.1) — which is why
the paper calls out the positional case in its motivation.

A copy of ``repro/index/positional.py`` (numpy) for the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import intersect as I
from ..core.repair import RePairResult, repair_compress
from ..core.sampling import BSampling, build_b_sampling


@dataclasses.dataclass
class PositionalCorpus:
    num_docs: int
    vocab_size: int
    stride: int                      # > max doc length
    doc_tokens: list[np.ndarray]     # token id sequence per doc


def positional_corpus(num_docs: int = 500, vocab_size: int = 2000,
                      mean_doc_len: int = 120, zipf_s: float = 1.3,
                      seed: int = 0) -> PositionalCorpus:
    """Zipf token stream with *bigram stickiness*: with probability 0.2 a
    token is followed by its fixed successor (term t -> t+1), creating
    real repeated phrases for the phrase-query tests."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    p /= p.sum()
    docs = []
    max_len = 0
    for _ in range(num_docs):
        n = max(8, int(rng.poisson(mean_doc_len)))
        toks = rng.choice(vocab_size, size=n, replace=True, p=p)
        follow = rng.random(n) < 0.2
        for i in range(1, n):
            if follow[i]:
                toks[i] = (toks[i - 1] + 1) % vocab_size
        docs.append(toks.astype(np.int64))
        max_len = max(max_len, n)
    stride = 1 << int(np.ceil(np.log2(max_len + 2)))
    return PositionalCorpus(num_docs=num_docs, vocab_size=vocab_size,
                            stride=stride, doc_tokens=docs)


class PositionalIndex:
    """Re-Pair compressed position lists + (b)-sampling + phrase queries."""

    def __init__(self, corpus: PositionalCorpus, B: int = 8):
        self.stride = corpus.stride
        term_pos: dict[int, list[int]] = {}
        for d, toks in enumerate(corpus.doc_tokens):
            base = d * corpus.stride
            for off, t in enumerate(toks):
                term_pos.setdefault(int(t), []).append(base + off)
        self.terms = np.asarray(sorted(term_pos), dtype=np.int64)
        self.term_to_list = {int(t): i for i, t in enumerate(self.terms)}
        lists = [np.asarray(term_pos[int(t)], dtype=np.int64)
                 for t in self.terms]
        self.lists = lists
        self.repair: RePairResult = repair_compress(lists)
        self.bsamp: BSampling = build_b_sampling(self.repair, B=B)

    def _list_id(self, term: int) -> int | None:
        return self.term_to_list.get(int(term))

    def positions(self, term: int) -> np.ndarray:
        i = self._list_id(term)
        if i is None:
            return np.empty(0, dtype=np.int64)
        return I.CompressedList(self.repair, i).decode()

    def phrase(self, terms: list[int], method: str = "lookup"
               ) -> np.ndarray:
        """Documents containing the exact phrase ``terms[0] terms[1] ...``.
        Intersects shifted position lists, shortest list first (§3.3),
        using the compressed accessors (lookup/(b)-sampling by default)."""
        ids = [self._list_id(t) for t in terms]
        if any(i is None for i in ids):
            return np.empty(0, dtype=np.int64)
        # candidate = positions of the RAREST term, shifted to the phrase
        # start; then verify against each other term's compressed list.
        lens = [int(self.repair.orig_lengths[i]) for i in ids]
        anchor = int(np.argmin(lens))
        cand = self.positions(terms[anchor]) - anchor   # phrase-start pos
        cand = cand[cand >= 0]
        for k, i in enumerate(ids):
            if k == anchor or cand.size == 0:
                continue
            shifted = cand + k                           # where term k sits
            if method == "lookup":
                acc: I.CompressedList = I.LookupList(self.repair, i,
                                                     self.bsamp)
            else:
                acc = I.CompressedList(self.repair, i)
            hits = I._svs_core(shifted, acc)
            keep = np.isin(shifted, hits, assume_unique=False)
            cand = cand[keep]
        # phrase must not straddle documents
        ok = (cand % self.stride) + len(terms) <= self.stride
        docs = np.unique(cand[ok] // self.stride)
        return docs

    def space_bits(self) -> int:
        from ..core.dictionary import build_forest
        return build_forest(self.repair.grammar).size_bits(
            self.repair.seq.size)
