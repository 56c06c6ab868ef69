"""Forest representation of the Re-Pair dictionary (paper §2.3, [GN07]).

The rule DAG is stored as a forest of binary trees:

* ``R_B`` — a bitmap over the preorder traversal of every tree: internal
  nodes are 1s, leaves are 0s.
* ``R_S`` — in the paper's phrase-sum variant (§3.2) entries are aligned to
  R_B positions: 1-positions carry the nonterminal's **phrase sum**, the
  0-positions carry the leaf value ("Thus rank is not anymore necessary to
  move from one sequence to the other").  We store that aligned array as
  ``rs_full`` and additionally the classic rank0-compacted ``rs``.

A nonterminal is identified by the (0-based) position of its 1-bit in
``R_B``.  As in the paper's example, when a nonterminal appears in the
right-hand side of a later rule, its tree is inlined at ONE such occurrence
(saving one integer); every other occurrence is a leaf holding
``num_terminals + position`` (the paper adds the maximum terminal value to
distinguish references from terminal gap values).

Rules never referenced by a later rule become the roots of the forest.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .repair import Grammar, RePairResult


@dataclasses.dataclass(frozen=True)
class DictForest:
    rb: np.ndarray            # (l,) uint8 preorder bitmap, 1=internal 0=leaf
    rs_full: np.ndarray       # (l,) int64: phrase sum at 1s, leaf value at 0s
    rs: np.ndarray            # (d,) int64 leaf values only (rank0 layout)
    pos_of_rule: np.ndarray   # (R,) int64 R_B position of each rule's 1-bit
    rule_of_pos: np.ndarray   # (l,) int64 rule index at 1-positions else -1
    num_terminals: int

    @property
    def num_leaves(self) -> int:
        return int(self.rs.size)

    def rank0(self, i: int) -> int:
        """#0s in rb[0..i] inclusive — the paper's rank_0(R_B, i)."""
        return int((self.rb[: i + 1] == 0).sum())

    def subtree_end(self, pos: int) -> int:
        """Exclusive end of the subtree starting at ``pos``: scan until we
        have seen more 0s than 1s (§2.3)."""
        ones = zeros = 0
        i = int(pos)
        while True:
            if self.rb[i]:
                ones += 1
            else:
                zeros += 1
            i += 1
            if zeros > ones:
                return i

    def expand_at(self, pos: int) -> list[int]:
        """Expand the subtree rooted at R_B position ``pos`` to terminal gap
        values, recursing into leaf references."""
        out: list[int] = []
        end = self.subtree_end(pos)
        for i in range(int(pos), end):
            if self.rb[i] == 0:
                v = int(self.rs_full[i])
                if v >= self.num_terminals:
                    out.extend(self.expand_at(v - self.num_terminals))
                else:
                    out.append(v)
        return out

    def phrase_sum_at(self, pos: int) -> int:
        assert self.rb[pos] == 1
        return int(self.rs_full[pos])

    # C-symbol helpers: a C symbol is either a terminal value or
    # num_terminals + R_B position of the nonterminal.
    def expand_symbol(self, sym: int) -> list[int]:
        if sym < self.num_terminals:
            return [int(sym)]
        return self.expand_at(sym - self.num_terminals)

    def symbol_sum(self, sym: int) -> int:
        if sym < self.num_terminals:
            return int(sym)
        return self.phrase_sum_at(sym - self.num_terminals)

    def symbol_len(self, sym: int) -> int:
        if sym < self.num_terminals:
            return 1
        return len(self.expand_at(sym - self.num_terminals))

    def size_bits(self, n_seq_symbols: int) -> int:
        """§3.4 accounting: S(l)=ceil(log2(sigma+l-2)) bits per entry of C
        and R_S (phrase sums included — they live in R_S, rho=1), plus l
        bits for R_B (o(l) rank overhead not charged)."""
        sigma = self.num_terminals
        l = int(self.rb.size)
        s_l = max(1, int(np.ceil(np.log2(max(2, sigma + l - 2)))))
        return (int(self.rs_full.size) + n_seq_symbols) * s_l + l


def build_forest(grammar: Grammar) -> DictForest:
    """Lay out the rule DAG as the paper's forest.

    Pass 1 decides, for every rule, whether it is inlined (at its first
    occurrence inside a later rule's RHS) or is a forest root.  Pass 2 emits
    preorder bits/values; pass 3 patches leaf references with final
    positions (references may point forward across trees).
    """
    R = grammar.num_rules
    nt = grammar.num_terminals
    if R == 0:
        return DictForest(
            rb=np.zeros(0, np.uint8),
            rs_full=np.zeros(0, np.int64),
            rs=np.zeros(0, np.int64),
            pos_of_rule=np.zeros(0, np.int64),
            rule_of_pos=np.zeros(0, np.int64),
            num_terminals=nt,
        )

    # inline_site[r] = (parent_rule, slot) where rule r's tree is inlined.
    inline_site: list[tuple[int, int] | None] = [None] * R
    for r in range(R):
        for slot in (0, 1):
            c = int(grammar.rules[r, slot])
            if c >= nt:
                cr = c - nt
                if inline_site[cr] is None:
                    inline_site[cr] = (r, slot)

    roots = [r for r in range(R) if inline_site[r] is None]

    bits: list[int] = []
    vals: list[int] = []        # aligned to bits; refs hold rule ids tagged
    is_ref: list[bool] = []     # vals[i] is a rule id needing position patch
    pos_of_rule = np.full(R, -1, dtype=np.int64)

    def emit(r: int) -> None:
        pos_of_rule[r] = len(bits)
        bits.append(1)
        vals.append(int(grammar.sums[r]))   # phrase sum on the 1-bit
        is_ref.append(False)
        for slot in (0, 1):
            c = int(grammar.rules[r, slot])
            if c < nt:
                bits.append(0)
                vals.append(c)
                is_ref.append(False)
            else:
                cr = c - nt
                if inline_site[cr] == (r, slot):
                    emit(cr)                 # inline the whole subtree
                else:
                    bits.append(0)
                    vals.append(cr)          # patched to nt+pos later
                    is_ref.append(True)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * R + 1000))
    try:
        for r in roots:
            emit(r)
    finally:
        sys.setrecursionlimit(old_limit)

    rb = np.asarray(bits, dtype=np.uint8)
    rs_full = np.asarray(vals, dtype=np.int64)
    ref_mask = np.asarray(is_ref, dtype=bool)
    # Patch references: leaf stores num_terminals + position of the rule.
    if ref_mask.any():
        ref_rules = rs_full[ref_mask]
        rs_full[ref_mask] = nt + pos_of_rule[ref_rules]
    rs = rs_full[rb == 0]
    rule_of_pos = np.full(rb.size, -1, dtype=np.int64)
    rule_of_pos[pos_of_rule] = np.arange(R)
    return DictForest(
        rb=rb,
        rs_full=rs_full,
        rs=rs,
        pos_of_rule=pos_of_rule,
        rule_of_pos=rule_of_pos,
        num_terminals=nt,
    )


def map_c_symbols(res: RePairResult, forest: DictForest) -> np.ndarray:
    """Translate the construction-time symbol stream (terminals and rule ids)
    into the forest addressing used by the paper's C: terminals stay, rule
    ``r`` becomes ``num_terminals + pos_of_rule[r]``."""
    nt = res.grammar.num_terminals
    seq = res.seq
    out = seq.copy()
    nt_mask = seq >= nt
    out[nt_mask] = nt + forest.pos_of_rule[seq[nt_mask] - nt]
    return out
