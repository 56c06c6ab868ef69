"""List intersection over Re-Pair compressed inverted lists (paper §3.3).

Algorithms implemented (all return numpy arrays of absolute doc ids):

* ``intersect_merge``      — full decode + linear merge (baseline).
* ``intersect_skip``       — no sampling: sequential scan of the longer list
                             using phrase sums to skip whole phrases (§3.2).
* ``intersect_svs``        — svs over (a)-sampling with sequential, binary,
                             or exponential (galloping) search in the samples,
                             then phrase-sum skipping below sample resolution.
* ``intersect_lookup``     — (b)-sampling: direct bucket addressing [ST07].
* ``intersect_multi``      — multi-list pairwise svs, lists sorted by
                             *uncompressed* length (stored separately, §3.3 —
                             Re-Pair compressed lengths are non-monotonic).

The scan model: a compressed list is consumed through a resumable cursor
``(j, s)`` — ``j`` = next symbol (relative to the list's span), ``s`` = value
of the last produced element (the list head before any symbol).  Phrases are
skipped whole via their phrase sums; only when the target provably falls
inside a phrase (s + sum >= x) do we descend its derivation tree, choosing
the left/right child by partial sums — O(depth) per descent, the mechanism
behind Theorem 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .repair import Grammar, RePairResult
from .sampling import ASampling, BSampling, _phrase_sums_for


@dataclasses.dataclass
class Cursor:
    j: int   # next symbol index within the list span
    s: int   # last produced element value


class CompressedList:
    """Accessor for one Re-Pair compressed list: skipping, next_geq,
    membership, expansion.  ``ops`` counts symbol touches (phrase skips +
    descent steps) — the machine-independent cost measure of §4."""

    def __init__(self, res: RePairResult, i: int):
        self.grammar = res.grammar
        self.syms = res.list_symbols(i)
        self.sums = _phrase_sums_for(self.syms, res.grammar)
        self.first = int(res.first_values[i])
        self.length = int(res.orig_lengths[i])
        self.last = self.first + int(self.sums.sum())
        self.ops = 0

    def cursor(self) -> Cursor:
        return Cursor(0, self.first)

    # -- phrase descent ----------------------------------------------------

    def _descend(self, sym: int, base: int, x: int) -> int:
        """Smallest element >= x inside the phrase of ``sym`` whose gaps
        start accumulating from ``base``.  Caller guarantees
        base + sum(sym) >= x.  O(depth of sym)."""
        g = self.grammar
        s = base
        while sym >= g.num_terminals:
            self.ops += 1
            l, r = g.rules[sym - g.num_terminals]
            ls = int(l) if l < g.num_terminals else int(g.sums[l - g.num_terminals])
            if s + ls >= x:
                sym = int(l)
            else:
                s += ls
                sym = int(r)
        return s + int(sym)  # terminal gap closes the element

    def next_geq(self, x: int, cur: Cursor) -> int | None:
        """Smallest element >= x at or after the cursor; advances the cursor
        past fully-consumed phrases (never into one, so it stays resumable
        for larger x)."""
        if cur.s >= x:
            return cur.s
        n = self.syms.size
        while cur.j < n:
            self.ops += 1
            ps = int(self.sums[cur.j])
            if cur.s + ps < x:
                cur.s += ps
                cur.j += 1
                continue
            return self._descend(int(self.syms[cur.j]), cur.s, x)
        return None

    def member(self, x: int, cur: Cursor | None = None) -> bool:
        cur = cur or self.cursor()
        v = self.next_geq(x, cur)
        return v == x

    def decode(self) -> np.ndarray:
        gaps: list[int] = []
        for sy in self.syms:
            gaps.extend(self.grammar.expand_symbol(int(sy)))
        body = self.first + np.cumsum(np.asarray(gaps, dtype=np.int64))
        return np.concatenate([np.asarray([self.first], dtype=np.int64), body])


# -- search over (a)-samples -----------------------------------------------

def _sample_bracket_seq(values: np.ndarray, x: int, lo: int) -> int:
    t = lo
    while t + 1 < values.size and values[t + 1] <= x:
        t += 1
    return t


def _sample_bracket_bin(values: np.ndarray, x: int, lo: int) -> int:
    t = int(np.searchsorted(values[lo:], x, side="right")) - 1 + lo
    return max(t, lo)


def _sample_bracket_exp(values: np.ndarray, x: int, lo: int) -> int:
    """Galloping from ``lo``: probe lo+2^j until overshoot, then binary."""
    n = values.size
    if n == 0 or values[lo] > x:
        return lo
    step = 1
    hi = lo
    while hi + step < n and values[hi + step] <= x:
        hi += step
        step <<= 1
    hi2 = min(n, hi + step)
    t = int(np.searchsorted(values[hi:hi2], x, side="right")) - 1 + hi
    return max(t, lo)


_BRACKETS = {
    "seq": _sample_bracket_seq,
    "bin": _sample_bracket_bin,
    "exp": _sample_bracket_exp,
}


class SampledList(CompressedList):
    """CompressedList + (a)-sampling accelerated next_geq."""

    def __init__(self, res: RePairResult, i: int, samp: ASampling,
                 search: str = "exp"):
        super().__init__(res, i)
        self.k = samp.k
        self.values = samp.values[i]
        self.bracket = _BRACKETS[search]
        self._t = 0  # resumable sample bracket

    def next_geq(self, x: int, cur: Cursor) -> int | None:
        if cur.s >= x:
            return cur.s
        # Jump the cursor with the samples when they get ahead of it.
        t = self.bracket(self.values, x, self._t)
        self._t = t
        jt = t * self.k
        if jt > cur.j:
            cur.j = jt
            cur.s = int(self.values[t])
        return super().next_geq(x, cur)


class LookupList(CompressedList):
    """CompressedList + (b)-sampling direct bucket addressing."""

    def __init__(self, res: RePairResult, i: int, samp: BSampling):
        super().__init__(res, i)
        self.kbits = samp.kbits[i]
        self.c_pos = samp.c_pos[i]
        self.abs_before = samp.abs_before[i]

    def next_geq(self, x: int, cur: Cursor) -> int | None:
        if cur.s >= x:
            return cur.s
        b = x >> self.kbits
        if b >= self.c_pos.size:
            # beyond the last bucket boundary we track; fall back to scan
            return super().next_geq(x, cur)
        jb = int(self.c_pos[b])
        if jb > cur.j:
            cur.j = jb
            cur.s = int(self.abs_before[b])
        return super().next_geq(x, cur)


# -- intersection algorithms -------------------------------------------------

def intersect_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear merge of two sorted id arrays (numpy set intersection keeps
    the comparison count equivalent; both inputs are strictly increasing)."""
    return np.intersect1d(a, b, assume_unique=True)


def _svs_core(short_ids: np.ndarray, acc: CompressedList) -> np.ndarray:
    out: list[int] = []
    cur = acc.cursor()
    for x in short_ids:
        x = int(x)
        if x > acc.last:
            break
        v = acc.next_geq(x, cur)
        if v is None:
            break
        if v == x:
            out.append(x)
    return np.asarray(out, dtype=np.int64)


def intersect_skip(res: RePairResult, i_short: int, i_long: int) -> np.ndarray:
    """No sampling: expand the short list, skip phrases on the long one."""
    short = CompressedList(res, i_short).decode()
    return _svs_core(short, CompressedList(res, i_long))


def intersect_svs(res: RePairResult, i_short: int, i_long: int,
                  samp: ASampling, search: str = "exp") -> np.ndarray:
    short = CompressedList(res, i_short).decode()
    return _svs_core(short, SampledList(res, i_long, samp, search))


def intersect_lookup(res: RePairResult, i_short: int, i_long: int,
                     samp: BSampling) -> np.ndarray:
    short = CompressedList(res, i_short).decode()
    return _svs_core(short, LookupList(res, i_long, samp))


def intersect_multi(res: RePairResult, idxs: list[int],
                    samp: ASampling | BSampling | None = None,
                    search: str = "exp") -> np.ndarray:
    """Pairwise svs from shortest to longest by UNCOMPRESSED length (§3.3),
    the strategy [BLOL06] found best in practice."""
    order = sorted(idxs, key=lambda i: int(res.orig_lengths[i]))
    cand = CompressedList(res, order[0]).decode()
    for i in order[1:]:
        if cand.size == 0:
            return cand
        if samp is None:
            acc: CompressedList = CompressedList(res, i)
        elif isinstance(samp, ASampling):
            acc = SampledList(res, i, samp, search)
        else:
            acc = LookupList(res, i, samp)
        cand = _svs_core(cand, acc)
    return cand


# -- uncompressed baselines (for comparisons in benchmarks) -----------------

def svs_uncompressed(short_ids: np.ndarray, long_ids: np.ndarray,
                     search: str = "exp") -> np.ndarray:
    out: list[int] = []
    lo = 0
    n = long_ids.size
    for x in short_ids:
        if search == "exp":
            step = 1
            hi = lo
            while hi + step < n and long_ids[hi + step] < x:
                hi += step
                step <<= 1
            hi2 = min(n, hi + step + 1)
            pos = int(np.searchsorted(long_ids[lo:hi2], x, side="left")) + lo
        else:
            pos = int(np.searchsorted(long_ids[lo:], x, side="left")) + lo
        lo = pos
        if pos < n and long_ids[pos] == x:
            out.append(int(x))
        if pos >= n:
            break
    return np.asarray(out, dtype=np.int64)


def baeza_yates(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[BY04] median/binary-search divide & conquer (reference baseline)."""
    out: list[int] = []

    def rec(a: np.ndarray, b: np.ndarray) -> None:
        if a.size == 0 or b.size == 0:
            return
        if a.size > b.size:
            rec(b, a)
            return
        mid = a.size // 2
        x = a[mid]
        pos = int(np.searchsorted(b, x, side="left"))
        rec(a[:mid], b[:pos])
        if pos < b.size and b[pos] == x:
            out.append(int(x))
        rec(a[mid + 1:], b[pos:])

    rec(a, b)
    return np.asarray(sorted(out), dtype=np.int64)
