"""Query streams: frozen copies of the port's workload generators, and the
one general generator that reads a traffic file.

``boolean_workload`` and ``ranked_workload`` give the same queries as
``repro_torch.launch.serve``'s functions of those names for the same
arguments (a test holds them together), as plain tuples and not the
program's AST:

* ``("term", t)``, ``("not", child)``, ``("and", children)``,
  ``("or", children)``, ``("phrase", terms)``;
* a ranked query is its list of term ids.

They consume the generator's stream exactly as the originals do; each
``Generator.choice`` with ``p`` is replayed as the search of ``random()``
draws in one cumulative distribution computed once.  Both are endless
generators, so a stream never runs out; its first ``n`` queries are the
originals' ``n_queries=n``.

A traffic file (``traffic/<name>.json``) names its closed-loop client
count, its warm-up length, its ``kind`` (``"bool"`` or ``"topk"``, with
the ranked ``k``) and the generator's parameters; ``QueryStream`` is
that generator's stream for a seed.

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def _popularity(num_lists: int, lengths, zipf_s: float):
    order = np.argsort(-np.asarray(lengths))         # popularity ranking
    p = np.arange(1, num_lists + 1, dtype=np.float64) ** (-zipf_s)
    p /= p.sum()
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    return order, p, cdf


def _draw_distinct(rng, p, cdf, k: int) -> np.ndarray:
    """``rng.choice(len(p), size=k, replace=False, p=p)``: draw, keep the
    first of each repeated index, and redraw the rest from ``p`` with
    the kept indices zeroed."""
    found = np.empty(0, np.int64)
    while found.size < k:
        x = rng.random(k - found.size)
        if found.size:
            q = p.copy()
            q[found] = 0
            c = np.cumsum(q)
            c /= c[-1]
        else:
            c = cdf
        new = c.searchsorted(x, side="right")
        _, first = np.unique(new, return_index=True)
        first.sort()
        found = np.concatenate([found, new.take(first)])
    return found


def boolean_workload(num_lists: int, lengths, seed, max_terms: int = 4,
                     p_or: float = 0.2, p_not: float = 0.12,
                     p_phrase: float = 0.12, zipf_s: float = 1.1
                     ) -> Iterator[tuple]:
    """Zipf boolean / phrase queries over the popularity ranking (longer
    list = more often queried): k-term AND (k in [2, max_terms]), an OR
    of two 2-term ANDs, an AND with its last term negated, and phrases
    of adjacent list ids."""
    rng = np.random.default_rng(seed)
    order, p, cdf = _popularity(num_lists, lengths, zipf_s)

    def draw_terms(k):
        return [int(order[r]) for r in _draw_distinct(rng, p, cdf, k)]

    while True:
        u = rng.random()
        k = int(rng.integers(2, max_terms + 1))
        if u < p_phrase:
            t0 = int(order[cdf.searchsorted(rng.random(), side="right")])
            yield ("phrase", tuple(min(t0 + j, num_lists - 1)
                                   for j in range(k)))
        elif u < p_phrase + p_not:
            ts = draw_terms(k)
            yield ("and", tuple([("term", t) for t in ts[:-1]]
                                + [("not", ("term", ts[-1]))]))
        elif u < p_phrase + p_not + p_or:
            a, b = draw_terms(2), draw_terms(2)
            yield ("or", (("and", (("term", a[0]), ("term", a[1]))),
                          ("and", (("term", b[0]), ("term", b[1])))))
        else:
            yield ("and", tuple(("term", t) for t in draw_terms(k)))


def ranked_workload(num_lists: int, lengths, seed, max_terms: int = 4,
                    zipf_s: float = 1.1) -> Iterator[list[int]]:
    """Bags of 2..max_terms distinct term ids drawn like the boolean
    queries' terms."""
    rng = np.random.default_rng(seed)
    order, p, cdf = _popularity(num_lists, lengths, zipf_s)
    while True:
        k = int(rng.integers(2, max_terms + 1))
        yield [int(order[r]) for r in _draw_distinct(rng, p, cdf, k)]


def render(node: tuple) -> str:
    """The query string of a boolean query, in the syntax the program's
    parser reads back into the same tree."""
    kind, arg = node
    if kind == "term":
        return str(arg)
    if kind == "phrase":
        return '"' + " ".join(map(str, arg)) + '"'
    if kind == "not":
        return "NOT " + render(arg)
    parts = [render(c) for c in arg]
    if kind == "and":
        return " AND ".join(p if c[0] != "or" else f"({p})"
                            for p, c in zip(parts, arg))
    return " OR ".join(f"({p})" for p in parts)


@dataclasses.dataclass(frozen=True)
class Query:
    kind: str                 # "bool" or "topk"
    query: object             # the tuple tree, or the term ids
    text: str                 # the query string, or a key naming the bag
    k: int = 0                # ranked: results asked for


_GENERATORS = {"bool": boolean_workload, "topk": ranked_workload}


class QueryStream:
    """The endless, seeded query stream of one traffic file."""

    def __init__(self, traffic: dict, num_lists: int, lengths, seed):
        self.kind, self.k = traffic["kind"], int(traffic.get("k", 0))
        self._gen = _GENERATORS[self.kind](
            num_lists, lengths, _words(seed), **traffic.get("generator", {}))

    def __iter__(self):
        return self

    def __next__(self) -> Query:
        q = next(self._gen)
        if self.kind == "topk":
            return Query("topk", q, f"top{self.k}:" + ",".join(map(str, q)),
                         k=self.k)
        return Query("bool", q, render(q))


def _words(seed) -> list[int]:
    """A seed (a whole number, or a list of them) as the entropy words of
    ``numpy.random.default_rng``; one number n and the list [n] draw the
    same stream."""
    seq = seed if isinstance(seed, (list, tuple)) else [seed]
    return [int(w) % (1 << 64) for w in seq]
