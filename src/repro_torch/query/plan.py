"""Cost-based query planner (DESIGN.md §7.2).

The planner turns an AST into a :class:`PlanNode` tree annotated with an
estimated result size, an estimated cost in **symbol touches** (the
machine-independent measure of paper §4: phrase skips + descent steps),
and — for conjunctive nodes — a per-step intersection algorithm:

* ``merge`` — decode both sides, linear merge.  Cost ``n_a + n_b``.
  Wins when the sides are comparable in length.
* ``svs``   — set-vs-set probing of the candidate set into the longer
  list's compressed stream via (b)-sampling bucket lookup + phrase-sum
  skipping (§3.3).  Cost ``|cand| * (B + depth)``: each probe pays the
  expected bucket scan (≈ the sampling parameter B) plus one grammar
  descent.  Wins when the candidate set is much smaller than the list.
* ``bys``   — Baeza-Yates-style binary search [BY04], run directly on the
  compressed stream: bisect the span's phrase-sum prefix table, then one
  descent.  Cost ``|cand| * (log2(m) + depth)`` where ``m`` is the
  COMPRESSED span length — Re-Pair shrinks the search domain, the reason
  the paper pairs BY with compressed lists.  Beats svs when
  ``log2(m) < B`` (short/highly-compressed spans).
* ``meld``  — k-way adaptive melding (Barbay–Kenyon style): all k cursors
  advance to a common frontier by batched next_geq rounds.  Cost
  ``k * n_min * (1 + depth)`` in the worst case; chosen for all-term
  conjunctions whose estimated alternation makes one k-way pass cheaper
  than k-1 pairwise passes.

Result-size estimation is the classic independence model over the
document domain D: ``|A AND B| ≈ |A||B|/D``, ``|A OR B| ≈ min(D, |A|+|B|)``,
``|NOT A| = D - |A|``.  Phrases get a fixed selectivity discount on top of
their conjunctive estimate.  Estimates only ever feed *relative* choices
(child order, algorithm), so the model's absolute error is harmless; the
differential gate (tests/test_query_plan.py) proves every choice returns
bit-identical results.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .ast import And, Node, Not, Or, Phrase, Term

#: Algorithms a conjunctive step may be lowered to.
ALGOS = ("merge", "svs", "bys", "meld")

#: Phrase selectivity discount vs the bag-of-words conjunction.
PHRASE_SELECTIVITY = 0.1


@dataclasses.dataclass(frozen=True)
class ListStats:
    """Per-list statistics the cost model reads (from the engine's
    RePairResult): uncompressed lengths, compressed span lengths, grammar
    depth, (b)-sampling parameter, and the document domain size."""

    lengths: np.ndarray        # (L,) uncompressed
    clens: np.ndarray          # (L,) compressed span symbols
    depth: int                 # max grammar descent depth
    B: int                     # (b)-sampling parameter (expected bucket scan)
    domain: int                # number of addressable documents
    #: (L,) per-list codec ids from the engine's adaptive tier
    #: (DESIGN.md §10) — None means all-repair.  Probe pricing only: the
    #: engine answers a probe on an EF/bitmap list from that codec's own
    #: store regardless of the svs/bys label, so the cost model charges
    #: the codec's per-probe constant instead of the repair scan+descent.
    codecs: np.ndarray | None = None

    @classmethod
    def from_engine(cls, engine, B: int = 8,
                    domain: int | None = None) -> "ListStats":
        res = engine.res
        starts = np.asarray(res.starts, np.int64)
        tier = getattr(engine, "tier", None)
        return cls(lengths=np.asarray(res.orig_lengths, np.int64),
                   clens=np.diff(starts),
                   depth=max(1, int(res.grammar.max_depth())),
                   B=B,
                   domain=int(domain if domain is not None
                              else res.universe),
                   codecs=None if tier is None else tier.codec)

    def valid(self, t: int) -> bool:
        return 0 <= t < self.lengths.size

    def n(self, t: int) -> float:
        return float(self.lengths[t]) if self.valid(t) else 0.0

    def m(self, t: int) -> float:
        return float(self.clens[t]) if self.valid(t) else 0.0

    def codec_of(self, t: int) -> int:
        if self.codecs is None or not self.valid(t):
            return 0
        return int(self.codecs[t])


@dataclasses.dataclass
class PlanNode:
    """One operator of the physical plan.  ``steps`` (conjunctions only)
    lists ``(child_position, algo)`` in execution order — child 0 of the
    order is the seed candidate set, every later step thins it."""

    node: Node
    op: str                           # term|and|or|not|phrase
    children: list["PlanNode"]
    est_n: float                      # estimated result cardinality
    est_cost: float                   # estimated symbol touches
    steps: list[tuple[int, str]] | None = None  # and/phrase lowering
    meld: bool = False                # whole-node k-way melding
    #: estimated ProbeRound suspension points of the lowered step machine
    #: (DESIGN.md §8.1) — the query's *batching depth*: how many coalescing
    #: ticks it needs end to end.  Or children lower in parallel, so an Or
    #: costs the max of its branches, not the sum.
    est_rounds: float = 0.0

    def algos(self) -> set[str]:
        out = {a for _, a in (self.steps or [])}
        if self.meld:
            out.add("meld")
        for c in self.children:
            out |= c.algos()
        return out


def _step_cost(stats: ListStats, cand: float, child: "PlanNode",
               force: str | None, probe_ok: bool) -> tuple[str, float]:
    """Pick the cheapest algorithm to intersect a materialized candidate
    set of size ``cand`` with ``child``.  Probe algorithms (svs/bys) need
    the right side to be a compressed list, i.e. a Term (and ``probe_ok``
    — over a positional index, doc-level steps cannot probe the position
    lists); any other child is materialized and merged."""
    d = float(stats.depth)
    if child.op != "term" or not probe_ok:
        return "merge", cand + child.est_cost + child.est_n
    t = child.node.t
    n, m = stats.n(t), stats.m(t)
    codec = stats.codec_of(t)
    if codec:
        from ..index.codec_tier import (T_BITMAP, T_BITMAP_SETUP, T_EF,
                                        T_EF_SETUP)
        # EF probe = select-sample bisect + SEL_PAGE scan + in-bucket
        # low-bits bisect: logarithmic in n with a constant (T_EF) on
        # top, plus a large per-ROUND setup charge (the fixed-trip select
        # machinery runs whatever the lane count) — so probing only beats
        # decode-and-merge on lists long enough to amortize the selects.
        # Bitmap membership is one word test with a small setup.
        if codec == 1:
            per_probe, setup = math.log2(max(2.0, n)) + T_EF, T_EF_SETUP
        else:
            per_probe, setup = float(T_BITMAP), T_BITMAP_SETUP
        costs = {
            "merge": cand + n,
            # svs and bys dispatch identically on a non-repair list (the
            # engine's codec router answers both from the same store), so
            # they price the same — the merge-vs-probe choice stays live
            "svs": cand * per_probe + setup,
            "bys": cand * per_probe + setup,
        }
    else:
        costs = {
            "merge": cand + n,
            "svs": cand * (stats.B + d),
            "bys": cand * (math.log2(max(2.0, m)) + d),
        }
    if force in costs:
        return force, costs[force]
    algo = min(costs, key=lambda k: (costs[k], k))
    return algo, costs[algo]


def make_plan(node: Node, stats: ListStats,
              force_algo: str | None = None,
              probe_terms: bool = True) -> PlanNode:
    """Lower an AST to a physical plan.  ``force_algo`` pins every
    conjunctive step to one algorithm (benchmark / differential-test axis);
    the planner still orders children shortest-first.  ``probe_terms=False``
    (positional indexes) restricts AND steps to merge — Phrase steps always
    may probe, their operands ARE the compressed position lists."""
    if force_algo is not None and force_algo not in ALGOS:
        raise ValueError(f"unknown algorithm {force_algo!r}; "
                         f"choose from {ALGOS}")
    D = float(max(1, stats.domain))

    if isinstance(node, Term):
        n = stats.n(node.t)
        return PlanNode(node, "term", [], est_n=n, est_cost=n)

    if isinstance(node, Not):
        c = make_plan(node.child, stats, force_algo, probe_terms)
        return PlanNode(node, "not", [c], est_n=D - c.est_n,
                        est_cost=c.est_cost + D, est_rounds=c.est_rounds)

    if isinstance(node, Or):
        kids = [make_plan(c, stats, force_algo, probe_terms)
                for c in node.children]
        est = min(D, sum(k.est_n for k in kids))
        return PlanNode(node, "or", kids,
                        est_n=est,
                        est_cost=sum(k.est_cost + k.est_n for k in kids),
                        # branches lower in parallel (exec._lower_parallel):
                        # the machine needs max, not sum, probe rounds
                        est_rounds=max((k.est_rounds for k in kids),
                                       default=0.0))

    if isinstance(node, (And, Phrase)):
        if isinstance(node, Phrase):
            kids = [make_plan(Term(t), stats, force_algo, probe_terms)
                    for t in node.terms]
            op = "phrase"
        else:
            kids = [make_plan(c, stats, force_algo, probe_terms)
                    for c in node.children]
            op = "and"
        if not kids:
            raise ValueError(f"empty {op} node (no children to intersect)")
        probe_ok = probe_terms or op == "phrase"
        # shortest-first by estimated size — the [BLOL06] svs order §3.3
        order = sorted(range(len(kids)), key=lambda i: (kids[i].est_n, i))
        est = D
        for k in kids:
            est *= k.est_n / D
        if op == "phrase":
            est *= PHRASE_SELECTIVITY
        # pairwise lowering: seed with the smallest child, then thin
        cand = kids[order[0]].est_n
        steps: list[tuple[int, str]] = [(order[0], "seed")]
        cost = kids[order[0]].est_cost
        rounds = kids[order[0]].est_rounds
        for pos in order[1:]:
            algo, c = _step_cost(stats, cand, kids[pos], force_algo,
                                 probe_ok)
            steps.append((pos, algo))
            cost += c
            # probe steps suspend once; merge steps evaluate the child
            rounds += (1.0 if algo in ("svs", "bys")
                       else kids[pos].est_rounds)
            cand = max(1.0, cand * kids[pos].est_n / D)
        # k-way adaptive melding: only meaningful for >= 3 bare terms, and
        # only when terms ARE doc-id lists (melding position lists would
        # intersect positions, not documents)
        all_terms = all(k.op == "term" for k in kids)
        if all_terms and len(kids) >= 3 and op == "and" and probe_terms:
            n_min = min(k.est_n for k in kids)
            meld_cost = len(kids) * n_min * (1.0 + stats.depth)
            # frontier chasing on a non-repair list pays the codec's
            # per-round setup on every alternation (~2*n_min rounds) —
            # the same charge _step_cost levies once per probe step
            kid_codecs = {stats.codec_of(k.node.t) for k in kids}
            if kid_codecs != {0}:
                from ..index.codec_tier import T_BITMAP_SETUP, T_EF_SETUP
                setup = (T_EF_SETUP if 1 in kid_codecs else T_BITMAP_SETUP)
                meld_cost += 2.0 * n_min * setup
            if force_algo == "meld" or (force_algo is None
                                        and meld_cost < cost):
                # frontier chasing: one round per alternation, bounded by
                # 2*n_min + 1 (every round either emits or skips past the
                # shortest list's next element)
                return PlanNode(node, op, kids, est_n=est,
                                est_cost=meld_cost, steps=None, meld=True,
                                est_rounds=1.0 + 2.0 * n_min)
        return PlanNode(node, op, kids, est_n=est, est_cost=cost,
                        steps=steps, est_rounds=rounds)

    raise TypeError(f"not a query node: {node!r}")


def explain(plan: PlanNode, indent: int = 0) -> str:
    """Human-readable plan tree (one line per operator)."""
    pad = "  " * indent
    if plan.op == "term":
        head = f"{pad}term({plan.node.t})"
    elif plan.meld:
        head = f"{pad}{plan.op}[meld x{len(plan.children)}]"
    elif plan.steps is not None:
        algos = ",".join(f"{p}:{a}" for p, a in plan.steps[1:])
        head = f"{pad}{plan.op}[seed={plan.steps[0][0]} {algos}]"
    else:
        head = f"{pad}{plan.op}"
    head += (f"  ~n={plan.est_n:.0f} cost={plan.est_cost:.0f} "
             f"rounds~{plan.est_rounds:.0f}")
    lines = [head]
    for c in plan.children:
        lines.append(explain(c, indent + 1))
    return "\n".join(lines)
