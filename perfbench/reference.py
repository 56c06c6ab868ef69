"""The plain reference: what every served answer is held to.

Written from the semantics alone, over the raw postings the benchmark
generated, in NumPy; it imports nothing of the program.

* Boolean queries are set algebra over doc ids: AND intersects, OR
  unites, NOT complements within ``[0, universe)`` (``universe`` is the
  largest doc id + 1), a phrase over a document-level index is the AND of
  its terms, and a term with no list is the empty set.
* Ranked queries are BM25 top-k under binary postings: ``score(d) =
  w(d) * sum(idf(t) for the query's terms t whose list holds d)`` with
  ``idf(t) = log(1 + (N - df + 0.5) / (df + 0.5))`` and ``w(d) = (k1 +
  1) / (1 + k1 * (1 - b + b * dl(d) / avgdl))``, where ``dl(d)`` counts
  the lists that hold d and N the documents in any list.  ``idf`` and
  ``w`` are worked out in float64 and rounded once to float32; the sum
  runs in float32 over the distinct in-vocabulary terms in ascending
  order, then one float32 product.  Documents rank by score descending,
  then doc id ascending.  This order of operations is the configuration's
  guarantee that scores are exact float32, bit for bit.

Two controls stand in the program's place to show the comparison fails
what it should: ``BloomReference`` answers boolean queries with an
approximate membership filter, and ``Bf16Reference`` scores in bfloat16.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.empty(0, np.int64)


class Reference:
    """Exact answers over ``lists`` (sorted int64 doc ids per list id)."""

    def __init__(self, lists, k1: float, b: float):
        self.lists = [np.asarray(l, np.int64) for l in lists]
        self.universe = max((int(l[-1]) + 1 for l in self.lists if l.size),
                            default=0)
        dl = np.zeros(max(1, self.universe), np.int64)
        for l in self.lists:
            dl[l] += 1
        ndocs = int((dl > 0).sum())
        avgdl = float(dl.sum() / max(ndocs, 1))
        df = np.asarray([l.size for l in self.lists], np.float64)
        self.idf = np.log1p((ndocs - df + 0.5) / (df + 0.5)) \
            .astype(np.float32)
        dlf = dl.astype(np.float64)
        w = (k1 + 1.0) / (1.0 + k1 * (1.0 - b + b * dlf / max(avgdl, 1e-12)))
        self.doc_w = np.where(dl > 0, w, 0.0).astype(np.float32)

    # -- boolean -------------------------------------------------------------

    def docs(self, t: int) -> np.ndarray:
        return self.lists[t] if 0 <= t < len(self.lists) else _EMPTY

    def boolean(self, node) -> np.ndarray:
        kind, arg = node
        if kind == "term":
            return self.docs(arg)
        if kind == "phrase":
            return self.boolean(("and", tuple(("term", t) for t in arg)))
        if kind == "not":
            return np.setdiff1d(np.arange(self.universe, dtype=np.int64),
                                self.boolean(arg), assume_unique=True)
        parts = [self.boolean(c) for c in arg]
        out = parts[0]
        for p in parts[1:]:
            out = (np.intersect1d(out, p, assume_unique=True)
                   if kind == "and" else np.union1d(out, p))
        return out.astype(np.int64)

    # -- ranked --------------------------------------------------------------

    def terms(self, bag) -> list[int]:
        return sorted({int(t) for t in bag if 0 <= int(t) < len(self.lists)})

    def _member(self, t: int) -> np.ndarray:
        m = np.zeros(self.doc_w.size, bool)
        m[self.lists[t]] = True
        return m

    def topk(self, bag, k: int) -> tuple[np.ndarray, np.ndarray]:
        acc = np.zeros(self.doc_w.size, np.float32)
        hit = np.zeros(self.doc_w.size, bool)
        for t in self.terms(bag):
            m = self._member(t)
            acc = acc + np.where(m, self.idf[t], np.float32(0.0))
            hit |= m
        scores = (self.doc_w * acc).astype(np.float32)
        return self._rank(scores, hit, k)

    @staticmethod
    def _rank(scores, hit, k):
        docs = np.flatnonzero(hit).astype(np.int64)
        order = np.lexsort((docs, -scores[docs].astype(np.float64)))
        top = docs[order[:max(0, int(k))]]
        return top, scores[top].astype(np.float32)


class BloomReference(Reference):
    """Control: every AND filters its candidates through a Bloom filter of
    each other term's list (``bits`` bits a posting, ``hashes`` hash
    functions) instead of an exact probe, and a NOT removes what the
    filter says is present — the shortcut of skipping the exact check
    after an approximate membership filter.  False positives break the
    exactness the configuration guarantees."""

    _P = (1 << 61) - 1

    def __init__(self, lists, k1, b, bits: int = 8, hashes: int = 5,
                 seed: int = 0):
        super().__init__(lists, k1, b)
        self.bits, rng = bits, np.random.default_rng(seed)
        self._a = rng.integers(1, 1 << 30, hashes, dtype=np.int64)
        self._c = rng.integers(0, 1 << 30, hashes, dtype=np.int64)
        self._filters: dict[int, np.ndarray] = {}

    def _slots(self, xs: np.ndarray, m: int) -> np.ndarray:
        x = np.asarray(xs, np.int64)[None, :]
        return ((x * self._a[:, None] + self._c[:, None]) % self._P) % m

    def _filter(self, t: int) -> np.ndarray:
        f = self._filters.get(t)
        if f is None:
            n = self.docs(t).size
            f = np.zeros(max(64, self.bits * n), bool)
            f[self._slots(self.docs(t), f.size).ravel()] = True
            self._filters[t] = f
        return f

    def _maybe(self, t: int, xs: np.ndarray) -> np.ndarray:
        if not 0 <= t < len(self.lists):
            return np.zeros(xs.size, bool)
        f = self._filter(t)
        return f[self._slots(xs, f.size)].all(axis=0)

    def boolean(self, node) -> np.ndarray:
        kind, arg = node
        if kind == "phrase":
            return self.boolean(("and", tuple(("term", t) for t in arg)))
        if kind != "and":
            return super().boolean(node)
        pos = [c for c in arg if c[0] != "not"]
        exact = [c for c in pos if c[0] != "term"]
        terms = [c[1] for c in pos if c[0] == "term"]
        if exact:
            cand = self.boolean(exact[0])
            rest = exact[1:]
        else:
            terms.sort(key=lambda t: self.docs(t).size)
            cand, terms, rest = self.docs(terms[0]), terms[1:], []
        for c in rest:
            cand = np.intersect1d(cand, self.boolean(c), assume_unique=True)
        for t in terms:
            cand = cand[self._maybe(t, cand)]
        for c in arg:
            if c[0] == "not":
                inner = c[1]
                drop = (self._maybe(inner[1], cand) if inner[0] == "term"
                        else np.isin(cand, self.boolean(inner)))
                cand = cand[~drop]
        return cand.astype(np.int64)


def _bf16(x) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), held in
    float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class Bf16Reference(Reference):
    """Control: the same BM25 with ``idf``, ``w``, every partial sum and
    the product rounded to bfloat16, the next precision below the
    configuration's float32."""

    def topk(self, bag, k: int):
        idf, doc_w = _bf16(self.idf), _bf16(self.doc_w)
        acc = np.zeros(doc_w.size, np.float32)
        hit = np.zeros(doc_w.size, bool)
        for t in self.terms(bag):
            m = self._member(t)
            acc = _bf16(acc + np.where(m, idf[t], np.float32(0.0)))
            hit |= m
        return self._rank(_bf16(doc_w * acc), hit, k)
