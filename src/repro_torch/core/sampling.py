"""(a)- and (b)-sampling over Re-Pair compressed lists (paper §3.2).

(a)-sampling [CM07-style, adapted]: one absolute value before every ``k``-th
symbol of the compressed sequence C of a list.  Because both the sampling
interval and the C entries are fixed-size, no offset pointers are needed —
"This is a plus compared to classical gap encoding methods".

(b)-sampling [ST07-style, adapted]: a sample whenever the absolute value
crosses a new multiple of ``2^k`` (regular in the *domain*).  Each sample
stores the position in C of the phrase containing the first element of the
bucket AND the absolute value accumulated before that phrase, because a
bucket boundary may fall inside a nonterminal ("several consecutive sampled
entries may point to the same position in C").

Both samplers work purely from phrase sums — the list is never expanded at
build time beyond one linear pass over its symbols.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .repair import Grammar, RePairResult


@dataclasses.dataclass(frozen=True)
class ASampling:
    """Per-list regular-in-C samples: ``values[j]`` is the absolute value
    accumulated before symbol ``j*k`` of the list's span (j=0 gives the
    list head value, before any gap symbol)."""

    k: int
    values: list[np.ndarray]     # one array per list

    def size_bits(self, universe: int) -> int:
        per = max(1, int(np.ceil(np.log2(max(2, universe)))))
        return int(sum(v.size for v in self.values)) * per


@dataclasses.dataclass(frozen=True)
class BSampling:
    """Per-list domain-regular samples.  For bucket b (values in
    [b*2^k, (b+1)*2^k)), ``c_pos[b]`` is the symbol offset (within the
    list's span) of the phrase containing the first element >= b*2^k and
    ``abs_before[b]`` the absolute value accumulated before that phrase.
    Buckets past the last element point one past the end."""

    kbits: list[int]             # per-list k (bucket width 2^k)
    c_pos: list[np.ndarray]
    abs_before: list[np.ndarray]

    def size_bits(self, universe: int, compressed_lens: np.ndarray) -> int:
        total = 0
        val_bits = max(1, int(np.ceil(np.log2(max(2, universe)))))
        for cp, _k, cl in zip(self.c_pos, self.kbits, compressed_lens):
            ptr_bits = max(1, int(np.ceil(np.log2(max(2, cl + 1)))))
            total += cp.size * (ptr_bits + val_bits)
        return total


def _phrase_sums_for(seq: np.ndarray, grammar: Grammar) -> np.ndarray:
    """Vectorized per-symbol gap sums: terminal value or rule phrase sum."""
    nt = grammar.num_terminals
    out = seq.astype(np.int64).copy()
    m = seq >= nt
    if m.any():
        out[m] = grammar.sums[seq[m] - nt]
    return out


def build_a_sampling(res: RePairResult, k: int) -> ASampling:
    values: list[np.ndarray] = []
    for i in range(res.num_lists):
        syms = res.list_symbols(i)
        sums = _phrase_sums_for(syms, res.grammar)
        # absolute value before symbol j*k  =  first + sum(sums[:j*k])
        csum = np.concatenate([[0], np.cumsum(sums)]) + int(res.first_values[i])
        idx = np.arange(0, syms.size + 1, k)
        values.append(csum[idx])
    return ASampling(k=k, values=values)


def choose_bucket_bits(universe: int, length: int, B: int = 8) -> int:
    """Paper/[ST07]: k = ceil(log2(u*B/l)) so a list of length l gets about
    l/B buckets."""
    if length <= 0:
        return max(1, int(np.ceil(np.log2(max(2, universe)))))
    return max(1, int(np.ceil(np.log2(max(2.0, universe * B / length)))))


def build_b_sampling(res: RePairResult, B: int = 8) -> BSampling:
    kbits: list[int] = []
    c_pos: list[np.ndarray] = []
    abs_before: list[np.ndarray] = []
    for i in range(res.num_lists):
        syms = res.list_symbols(i)
        sums = _phrase_sums_for(syms, res.grammar)
        first = int(res.first_values[i])
        last = first + int(sums.sum())
        k = choose_bucket_bits(res.universe, int(res.orig_lengths[i]), B)
        n_buckets = (res.universe >> k) + 1
        # cumulative absolute value AFTER each symbol; before symbol j it is
        # cum[j] (cum[0] = first = the head element).
        cum = np.concatenate([[first], first + np.cumsum(sums)])
        bounds = (np.arange(n_buckets, dtype=np.int64) << k)
        # First symbol index whose *end* value reaches the boundary: the
        # first element >= bound lies inside that symbol's phrase (or is the
        # head).  searchsorted over cum[1:] finds it; abs_before = cum[idx].
        idx = np.searchsorted(cum[1:], bounds, side="left")
        # Clamp: boundaries past the last element point past the end.
        idx = np.minimum(idx, syms.size)
        ab = cum[idx]
        # Head element special case: if bound <= first the scan must start
        # at symbol 0 with abs_before = first (head is itself an element).
        c_pos.append(idx.astype(np.int64))
        abs_before.append(ab.astype(np.int64))
        kbits.append(k)
    return BSampling(kbits=kbits, c_pos=c_pos, abs_before=abs_before)
