"""§3.4 "Optimizing space": choose how many trailing Re-Pair rules to keep.

The paper completes compression and then successively *unrolls* the last
symbol added, predicting the total size at every prefix of the rule set via
Observation 1, and keeps the prefix that minimizes total bits:

    total(l) = (d + n) * S(l) + l,     S(l) = ceil(log2(sigma + l - 2))

where each remaining rule also pays rho = 1 phrase-sum entries (stored in
R_S units).  Unrolling rule  s -> s1 s2  with k occurrences in C:

    * C grows by k symbols (each occurrence becomes two),
    * R_S loses  rho + c(s1) + c(s2)  entries and R_B loses
      f(s) = 1 + c(s1) + c(s2)  bits, where c(a)=1 iff rule a was INLINED
      under s in the forest (i.e. s is the first later rule using a) — if
      so, a's subtree must pop out as a new forest root, which costs nothing
      extra, but the leaf that the inline replaced comes back.

Implementation detail: we evaluate the predicted size for every cut point
R' = 0..R in O(R) (Observation 1 makes each step O(1) given the occurrence
counts and inline structure) and then actually materialize the cut:
discarded rules are expanded back into C.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .repair import Grammar, RePairResult


@dataclasses.dataclass(frozen=True)
class OptimizeReport:
    best_num_rules: int
    best_bits: int
    bits_at_cut: np.ndarray     # predicted total bits for each cut 0..R
    orig_bits: int


def _structure_counts(res: RePairResult) -> tuple[np.ndarray, np.ndarray]:
    """occ[r]   = occurrences of rule r in C plus in RHS of kept rules
                  (recomputed per cut analytically below — here we return
                  occurrences in C and a (R,2) child table).
    """
    nt = res.grammar.num_terminals
    R = res.grammar.num_rules
    occ_c = np.zeros(R, dtype=np.int64)
    syms = res.seq[res.seq >= nt] - nt
    if syms.size:
        np.add.at(occ_c, syms, 1)
    return occ_c, res.grammar.rules.copy()


def predict_sizes(res: RePairResult, rho: int = 1) -> np.ndarray:
    """Predicted total size in bits for every cut R' (keep rules 0..R'-1),
    walking cuts from R down to 0 and applying Observation 1 per step.

    State walked backwards: n = |C| symbols, occurrences occ[r] of each rule
    in C (occurrences inside later kept rules' RHS unroll into C occurrences
    as those rules are themselves unrolled).
    """
    g = res.grammar
    nt = g.num_terminals
    R = g.num_rules
    occ, children = _structure_counts(res)
    # occurrences of each rule inside RHS of *kept* rules
    rhs_occ = np.zeros(R, dtype=np.int64)
    for r in range(R):
        for c in children[r]:
            if c >= nt:
                rhs_occ[c - nt] += 1

    n = res.seq.size
    sizes = np.empty(R + 1, dtype=np.int64)

    def total_bits(n_sym: int, kept: int, d_leaves: int, l_bits: int) -> int:
        sigma = nt
        s_l = max(1, int(np.ceil(np.log2(max(2, sigma + l_bits - 2)))))
        return (d_leaves + n_sym + rho * kept) * s_l + l_bits

    # Forest structure sizes for a cut: each kept rule contributes 1 internal
    # bit + 2 child slots; a child slot is a leaf (bit 0 + 1 R_S entry)
    # unless the child rule is inlined there (then its subtree substitutes —
    # no leaf).  Each rule is inlined at most once; rules never inlined are
    # roots.  With kept = K rules: internal bits = K, leaves = 2K - (#inlined
    # kept rules), where #inlined = K - #roots.
    # Walk cuts from R down to 0, maintaining n and counts.
    # For the leaf count we need, per cut K, how many of rules 0..K-1 are
    # referenced by some rule < K (those get inlined once).
    first_user = np.full(R, -1, dtype=np.int64)  # first rule using r in RHS
    for r in range(R):
        for c in children[r]:
            if c >= nt and first_user[c - nt] == -1:
                first_user[c - nt] = r

    # inlined_under_cut[K] = #{r < K : first_user[r] != -1 and first_user[r] < K}
    # first_user[r] > r always (rules reference earlier symbols), so the
    # condition is first_user[r] < K.  Precompute via sorting.
    fu = first_user.copy()
    inlined_sorted = np.sort(fu[fu >= 0])

    def inlined_count(K: int) -> int:
        return int(np.searchsorted(inlined_sorted, K, side="left"))

    occ_total = occ.copy()  # occurrences in C for current cut (starts full)
    cur_n = int(n)
    sizes_rev: list[int] = []
    for K in range(R, -1, -1):
        inl = inlined_count(K)
        leaves = 2 * K - inl
        l_bits = K + leaves  # 1 bit per internal + 1 per leaf
        sizes_rev.append(total_bits(cur_n, K, leaves, l_bits))
        if K > 0:
            r = K - 1
            k_occ = int(occ_total[r])
            # unrolling r: each C occurrence becomes its two children
            cur_n += k_occ
            for c in children[r]:
                if c >= nt:
                    occ_total[c - nt] += k_occ
            # occurrences of r inside RHS of rules < K-1: none reference a
            # LATER rule, and all rules >= K are already unrolled, so done.
    sizes[:] = sizes_rev[::-1]
    return sizes


def optimize_rules(res: RePairResult, rho: int = 1) -> tuple[RePairResult, OptimizeReport]:
    """Find the size-minimizing cut and materialize it (expand dropped
    rules back into C).  Returns the new result + report."""
    sizes = predict_sizes(res, rho)
    best = int(np.argmin(sizes))
    report = OptimizeReport(
        best_num_rules=best,
        best_bits=int(sizes[best]),
        bits_at_cut=sizes,
        orig_bits=int(sizes[-1]),
    )
    if best == res.grammar.num_rules:
        return res, report
    return truncate_rules(res, best), report


def truncate_rules(res: RePairResult, keep: int) -> RePairResult:
    """Keep only the first ``keep`` rules; expand every discarded symbol in C
    down to symbols < nt+keep.  Cost proportional to the output size."""
    g = res.grammar
    nt = g.num_terminals
    limit = nt + keep

    memo: dict[int, list[int]] = {}

    def expand_to_limit(sym: int) -> list[int]:
        if sym < limit:
            return [sym]
        if sym in memo:
            return memo[sym]
        l, r = g.rules[sym - nt]
        out = expand_to_limit(int(l)) + expand_to_limit(int(r))
        memo[sym] = out
        return out

    new_seq: list[int] = []
    new_starts = np.zeros(res.num_lists + 1, dtype=np.int64)
    for i in range(res.num_lists):
        for s in res.list_symbols(i):
            new_seq.extend(expand_to_limit(int(s)))
        new_starts[i + 1] = len(new_seq)

    new_grammar = Grammar(
        num_terminals=nt,
        rules=g.rules[:keep].copy(),
        sums=g.sums[:keep].copy(),
        lengths=g.lengths[:keep].copy(),
        depths=g.depths[:keep].copy(),
    )
    return RePairResult(
        grammar=new_grammar,
        seq=np.asarray(new_seq, dtype=np.int64),
        starts=new_starts,
        first_values=res.first_values,
        orig_lengths=res.orig_lengths,
        universe=res.universe,
    )
