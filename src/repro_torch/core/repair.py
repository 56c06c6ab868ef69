"""Re-Pair construction over concatenated d-gap inverted lists.

Implements both the exact algorithm of Larsson & Moffat [LM00] and the
approximate multi-pair-per-round variant of Claude & Navarro [CN07] that the
paper uses (parameter ``k`` caps the pair-count table, many disjoint pairs are
replaced per round).

Construction is a host-side (numpy) offline job, as in the paper (the TREC
collection compresses in 1.5 min on a 2008 laptop).  The output artifacts —
compressed sequence ``C``, rule table, per-list spans — feed both the
bit-exact CPU structures (``intersect.py``) and the device-resident mirror
(``index.py``).

Terminals are the d-gap values themselves (value ``g`` is terminal symbol
``g``), exactly as §3.1 of the paper prescribes.  Nonterminal ids start at
``num_terminals`` and each maps to a rule ``s -> (left, right)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# Sentinel used between lists during construction so no phrase spans two
# lists (§3.1: "A unique integer will be appended to the beginning of each
# list prior to the concatenation").  We implement separators as *unique*
# negative slots remapped to one-shot symbols, which by construction can
# never participate in a repeated pair.
_SEP = -1


@dataclasses.dataclass(frozen=True)
class Grammar:
    """A Re-Pair grammar: rules[i] = (left, right) for nonterminal
    ``num_terminals + i``.  ``sums`` and ``lengths`` are the phrase sums /
    expanded lengths of every nonterminal (§3.2 "phrase sums")."""

    num_terminals: int
    rules: np.ndarray          # (R, 2) int64 symbol ids
    sums: np.ndarray           # (R,)  int64 sum of gaps the rule expands to
    lengths: np.ndarray        # (R,)  int64 expanded length
    depths: np.ndarray         # (R,)  int32 parse-tree depth (leaf = 0)

    @property
    def num_rules(self) -> int:
        return int(self.rules.shape[0])

    @property
    def num_symbols(self) -> int:
        return self.num_terminals + self.num_rules

    def is_terminal(self, sym: int) -> bool:
        return sym < self.num_terminals

    def expand_symbol(self, sym: int) -> list[int]:
        """Expand one symbol to its terminal (gap) sequence.  Iterative
        explicit-stack expansion; cost proportional to output length."""
        out: list[int] = []
        stack = [int(sym)]
        while stack:
            s = stack.pop()
            if s < self.num_terminals:
                out.append(s)
            else:
                l, r = self.rules[s - self.num_terminals]
                stack.append(int(r))
                stack.append(int(l))
        return out

    def max_depth(self) -> int:
        return int(self.depths.max(initial=0))


@dataclasses.dataclass(frozen=True)
class RePairResult:
    """Compressed form of a set of inverted lists."""

    grammar: Grammar
    seq: np.ndarray            # C — compressed symbol stream, all lists
    starts: np.ndarray         # (L+1,) span of list i is seq[starts[i]:starts[i+1]]
    first_values: np.ndarray   # (L,) p_1 of each list (head stored absolutely)
    orig_lengths: np.ndarray   # (L,) uncompressed lengths (needed by §3.3)
    universe: int              # max document id + 1

    @property
    def num_lists(self) -> int:
        return int(self.starts.shape[0] - 1)

    def list_symbols(self, i: int) -> np.ndarray:
        return self.seq[self.starts[i] : self.starts[i + 1]]

    def decode_list(self, i: int) -> np.ndarray:
        """Decompress list ``i`` back to absolute, strictly increasing doc ids."""
        syms = self.list_symbols(i)
        gaps: list[int] = []
        for s in syms:
            gaps.extend(self.grammar.expand_symbol(int(s)))
        first = int(self.first_values[i])
        body = first + np.cumsum(np.asarray(gaps, dtype=np.int64))
        return np.concatenate([np.asarray([first], dtype=np.int64), body])

    def compressed_length(self, i: int) -> int:
        return int(self.starts[i + 1] - self.starts[i])


def lists_to_gap_stream(
    lists: Sequence[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Differentially encode each strictly-increasing list and concatenate
    with separators.  Returns (stream, first_values, list_lengths, universe).

    The first element of each list is stored out-of-band (``first_values``) so
    the stream holds only the ``len-1`` gaps per list — gap statistics are the
    thing Re-Pair should see (§3.1).
    """
    parts: list[np.ndarray] = []
    firsts = np.empty(len(lists), dtype=np.int64)
    lens = np.empty(len(lists), dtype=np.int64)
    universe = 0
    for i, pl in enumerate(lists):
        pl = np.asarray(pl, dtype=np.int64)
        if pl.size == 0:
            raise ValueError(f"list {i} is empty")
        if pl.size > 1 and not (np.diff(pl) > 0).all():
            raise ValueError(f"list {i} is not strictly increasing")
        firsts[i] = pl[0]
        lens[i] = pl.size
        universe = max(universe, int(pl[-1]) + 1)
        gaps = np.diff(pl)
        parts.append(gaps)
        parts.append(np.asarray([_SEP], dtype=np.int64))
    stream = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
    return stream, firsts, lens, universe


def _pair_counts_capped(seq: np.ndarray, active: np.ndarray, cap: int):
    """Vectorized pair counting with an optional cap on distinct pairs kept,
    mirroring [CN07]'s limited-capacity hash tables: only pairs appearing
    *early* in the sequence are considered when the table fills.

    Returns (pairs, counts) sorted by count descending, pairs as (K,2) array.
    Separator positions (active=False) never participate.
    """
    a = seq[:-1]
    b = seq[1:]
    valid = active[:-1] & active[1:]
    if not valid.any():
        return np.empty((0, 2), dtype=np.int64), np.empty(0, dtype=np.int64)
    pa = a[valid]
    pb = b[valid]
    if cap > 0 and pa.size > 0:
        # Keep only pairs whose first occurrence is among the first ``cap``
        # distinct pairs in sequence order ([CN07] early-pairs policy).
        key = pa * (seq.max() + 2) + pb
        _, first_idx = np.unique(key, return_index=True)
        if first_idx.size > cap:
            keep_keys = key[np.sort(first_idx)[:cap]]
            mask = np.isin(key, keep_keys)
            pa, pb = pa[mask], pb[mask]
    key = pa * (seq.max() + 2) + pb
    uniq, counts = np.unique(key, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    uniq = uniq[order]
    counts = counts[order]
    base = seq.max() + 2
    pairs = np.stack([uniq // base, uniq % base], axis=1)
    return pairs, counts


def _replace_pairs_batch(
    seq: np.ndarray,
    active: np.ndarray,
    pairs: np.ndarray,
    new_ids: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace every non-overlapping occurrence of each pair (left-to-right
    greedy, as Re-Pair requires: in ``aaa`` only one ``aa`` is replaced).

    Vectorized approach: mark candidate positions for all chosen pairs at
    once, resolve overlaps with a parity scan inside runs, then compact.
    Returns (new_seq, new_active, per_pair_replacement_counts).
    """
    n = seq.size
    pair_map = {(int(l), int(r)): int(s) for (l, r), s in zip(pairs, new_ids)}
    # Candidate mask: position i starts a chosen pair.
    cand = np.zeros(n, dtype=bool)
    repl_sym = np.zeros(n, dtype=np.int64)
    a, b = seq[:-1], seq[1:]
    valid = active[:-1] & active[1:]
    # Vectorize the lookup per pair (few pairs per round -> few passes).
    counts = np.zeros(len(pairs), dtype=np.int64)
    for j, (l, r) in enumerate(pairs):
        m = valid & (a == l) & (b == r)
        idx = np.nonzero(m)[0]
        if idx.size == 0:
            continue
        cand[idx] = True
        repl_sym[idx] = pair_map[(int(l), int(r))]

    if not cand.any():
        return seq, active, counts

    # Resolve overlaps greedily left-to-right: a candidate at i is taken iff
    # i-1 was not taken.  Within a run of consecutive candidates, taken
    # positions are the even offsets.  Two *different* pairs can only overlap
    # if they share a symbol; the parity rule still implements greedy L2R.
    taken = np.zeros(n, dtype=bool)
    idx = np.nonzero(cand)[0]
    # run starts: candidate whose predecessor position is not a candidate
    run_start = np.ones(idx.size, dtype=bool)
    run_start[1:] = idx[1:] != idx[:-1] + 1
    run_id = np.cumsum(run_start) - 1
    first_of_run = idx[run_start]
    offset = idx - first_of_run[run_id]
    taken_idx = idx[offset % 2 == 0]
    taken[taken_idx] = True

    # Count replacements per pair.
    tsyms = repl_sym[taken_idx]
    for j, s in enumerate(new_ids):
        counts[j] = int((tsyms == s).sum())

    # Build output: taken position i emits new symbol, i+1 is dropped.
    drop = np.zeros(n, dtype=bool)
    drop[taken_idx + 1] = True
    out = seq.copy()
    out[taken_idx] = repl_sym[taken_idx]
    keep = ~drop
    return out[keep], active[keep], counts


def repair_compress(
    lists: Sequence[np.ndarray],
    *,
    max_rules: int | None = None,
    min_count: int = 2,
    pairs_per_round: int = 64,
    table_cap: int = 0,
    exact: bool = False,
) -> RePairResult:
    """Compress inverted lists with Re-Pair over their d-gaps.

    Parameters
    ----------
    lists:            strictly-increasing integer doc-id arrays.
    max_rules:        stop after this many rules (None = run to fixpoint).
    min_count:        stop when the best pair occurs fewer than this many
                      times (2 = paper's "until every pair appears once").
    pairs_per_round:  [CN07] approximation: replace up to this many disjoint
                      top pairs per round (1 = exact Re-Pair order).
    table_cap:        [CN07] limited-capacity counting (0 = unlimited).
    exact:            shorthand for pairs_per_round=1, table_cap=0.
    """
    if exact:
        pairs_per_round, table_cap = 1, 0

    stream, firsts, lens, universe = lists_to_gap_stream(lists)

    # Remap: terminals are gap values themselves (0..max_gap); separators get
    # unique one-shot ids above the terminal range so no pair repeats across
    # them.  num_terminals = max_gap+1 keeps "value g == terminal g" (§3.1).
    max_gap = int(stream[stream != _SEP].max(initial=0))
    num_terminals = max_gap + 1
    n_sep = int((stream == _SEP).sum())
    seq = stream.copy()
    sep_pos = np.nonzero(stream == _SEP)[0]
    # Separators marked inactive; they are removed at the end (§3.1).
    active = np.ones(seq.size, dtype=bool)
    active[sep_pos] = False
    seq[sep_pos] = np.arange(n_sep, dtype=np.int64)  # value irrelevant

    rules: list[tuple[int, int]] = []
    sums: list[int] = []
    lengths: list[int] = []
    depths: list[int] = []

    def sym_sum(s: int) -> int:
        return s if s < num_terminals else sums[s - num_terminals]

    def sym_len(s: int) -> int:
        return 1 if s < num_terminals else lengths[s - num_terminals]

    def sym_depth(s: int) -> int:
        return 0 if s < num_terminals else depths[s - num_terminals]

    next_id = num_terminals
    while True:
        if max_rules is not None and len(rules) >= max_rules:
            break
        pairs, counts = _pair_counts_capped(seq, active, table_cap)
        good = counts >= min_count
        pairs, counts = pairs[good], counts[good]
        if pairs.shape[0] == 0:
            break
        take = min(pairs_per_round, pairs.shape[0])
        if max_rules is not None:
            take = min(take, max_rules - len(rules))
        # Chosen pairs must be pairwise disjoint in *symbols* to be safely
        # replaced in one vectorized pass (a symbol in one pair could be
        # consumed by another).  Greedy filter by count order.
        chosen: list[tuple[int, int]] = []
        used: set[int] = set()
        for (l, r), c in zip(pairs, counts):
            l, r = int(l), int(r)
            if l in used or r in used:
                continue
            chosen.append((l, r))
            used.update((l, r))
            if len(chosen) >= take:
                break
        if not chosen:
            chosen = [(int(pairs[0][0]), int(pairs[0][1]))]
        new_ids = np.arange(next_id, next_id + len(chosen), dtype=np.int64)
        seq, active, rep_counts = _replace_pairs_batch(
            seq, active, np.asarray(chosen, dtype=np.int64), new_ids
        )
        # Register rules; drop rules that ended up unused (possible when the
        # same positions were contested between chosen pairs).
        kept_any = False
        for (l, r), c in zip(chosen, rep_counts):
            # Always register — C may still reference the id even when c is
            # small; ids were already written into seq.
            rules.append((l, r))
            sums.append(sym_sum(l) + sym_sum(r))
            lengths.append(sym_len(l) + sym_len(r))
            depths.append(1 + max(sym_depth(l), sym_depth(r)))
            kept_any = kept_any or c > 0
        next_id += len(chosen)
        if not kept_any:
            break

    # Strip separators, record per-list spans.
    out_syms = seq[active]
    # Span boundaries: positions of separators in the *current* seq.
    sep_mask = ~active
    # For list i, its span is between separator i-1 and separator i.
    # Compute cumulative counts of active symbols before each separator.
    active_cum = np.cumsum(active)
    sep_idx = np.nonzero(sep_mask)[0]
    ends = active_cum[sep_idx]  # number of active syms up to & incl sep i
    starts = np.concatenate([[0], ends]).astype(np.int64)

    grammar = Grammar(
        num_terminals=num_terminals,
        rules=np.asarray(rules, dtype=np.int64).reshape(-1, 2),
        sums=np.asarray(sums, dtype=np.int64),
        lengths=np.asarray(lengths, dtype=np.int64),
        depths=np.asarray(depths, dtype=np.int32),
    )
    return RePairResult(
        grammar=grammar,
        seq=out_syms.astype(np.int64),
        starts=starts,
        first_values=firsts,
        orig_lengths=lens,
        universe=universe,
    )



def repair_result_to_arrays(res: RePairResult
                            ) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """Every array of a :class:`RePairResult` (and its grammar) by name,
    plus its two scalars — what :func:`repair_result_from_arrays` takes."""
    g = res.grammar
    arrays = dict(rules=g.rules, sums=g.sums, lengths=g.lengths,
                  depths=g.depths, seq=res.seq, starts=res.starts,
                  first_values=res.first_values,
                  orig_lengths=res.orig_lengths)
    statics = dict(num_terminals=int(g.num_terminals),
                   universe=int(res.universe))
    return {k: np.asarray(v) for k, v in arrays.items()}, statics


def repair_result_from_arrays(arrays: dict[str, np.ndarray],
                              statics: dict) -> RePairResult:
    """Rebuild a :class:`RePairResult` from numpy arrays named like the
    fields of it and of its :class:`Grammar` — so a result compressed by
    another package (same field names) carries over without recompressing."""
    grammar = Grammar(num_terminals=int(statics["num_terminals"]),
                      rules=np.asarray(arrays["rules"]).reshape(-1, 2),
                      sums=np.asarray(arrays["sums"]),
                      lengths=np.asarray(arrays["lengths"]),
                      depths=np.asarray(arrays["depths"]))
    return RePairResult(grammar=grammar, seq=np.asarray(arrays["seq"]),
                        starts=np.asarray(arrays["starts"]),
                        first_values=np.asarray(arrays["first_values"]),
                        orig_lengths=np.asarray(arrays["orig_lengths"]),
                        universe=int(statics["universe"]))
