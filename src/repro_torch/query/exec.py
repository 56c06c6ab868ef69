"""Plan executor: lowers a :class:`~repro_torch.query.plan.PlanNode` tree onto
the backend-pluggable Engine API (DESIGN.md §7.3, §8.1).

Lowering no longer runs to completion: ``lower(plan)`` yields a
**resumable step machine** — a generator of typed steps
(:class:`~repro_torch.query.steps.ProbeRound` / ``DecodeList`` / ``SetOp`` /
``PhraseShift``) that suspends at every step until a driver sends the
result back in.  The generator frame is the continuation, so a query can
be parked between engine calls; the serving scheduler
(``repro_torch.serve.scheduler``) exploits exactly that to coalesce the pending
probe rounds of many concurrent queries into shared device dispatches.
``run_plan`` is the degenerate single-query driver (``steps.drive``).

The conjunctive steps are where the engines earn their keep:

* ``svs`` steps stream the candidate set through ``ProbeRound("svs")``
  — one batched probe round per step, which is the bucket+skip kernel on
  the device engines (and the shard_map dispatch when the engine carries a
  mesh);
* ``bys`` steps yield ``ProbeRound("bys")``, the batched binary-search
  primitive;
* ``meld`` conjunctions chase a common frontier with one ``ProbeRound``
  per alternation round (Barbay–Kenyon style, lowered here rather than
  inside the engine so meld rounds coalesce across queries too);
* ``merge`` steps decode through ``DecodeList`` and intersect on host.

``Or`` children are independent subtrees, so their machines advance in
lockstep and same-algorithm probe rounds merge into ONE yielded
``ProbeRound`` — intra-query coalescing with the same convention the
cross-query scheduler uses.

Two index shapes are supported:

* **document-level** (default): term ids address doc-id lists; ``Phrase``
  degrades to its conjunction (the two-level AND-then-verify skeleton of
  the paper's introduction — verification needs positions we don't have).
* **positional** (``positional=stride``): term ids address position lists
  (doc * stride + offset, cf. ``index/positional.py``).  ``Term``/boolean
  ops project positions onto documents; ``Phrase`` intersects *shifted*
  position lists with per-step svs/bys probes — "phrase queries can be
  solved essentially by intersecting word positions" (paper §1) — and
  drops windows that would straddle a document boundary.
"""

from __future__ import annotations

import numpy as np

from ..core.index import INT_INF
from .ast import And, Node, Not, Or, Phrase, Term, terms_of
from .parser import parse
from .plan import ListStats, PlanNode, make_plan
from .steps import DecodeList, PhraseShift, ProbeRound, SetOp, drive

_EMPTY = np.empty(0, dtype=np.int64)

#: sentinel priming a sub-machine that has not started yet
_PRIME = object()


def _until_probe(machine, send):
    """Advance one sub-machine until it blocks on a :class:`ProbeRound`
    or finishes.  Non-probe steps are forwarded upward for the outer
    driver to fulfil.  Returns ``("probe", round)`` or ``("done", val)``."""
    try:
        step = next(machine) if send is _PRIME else machine.send(send)
        while not isinstance(step, ProbeRound):
            res = yield step
            step = machine.send(res)
        return ("probe", step)
    except StopIteration as stop:
        return ("done", stop.value)


class QueryExecutor:
    """Bind a planner to one engine.

    ``force_algo`` pins every conjunctive step ("merge"/"svs"/"bys"/
    "meld") — the benchmark and differential-test axis.  ``domain`` is the
    document-id domain for ``Not`` (default: the index universe, or
    ``positions_universe // stride`` for positional indexes).  ``stats``
    shares one precomputed :class:`ListStats` across executors over the
    same index (the scheduler builds one executor per forced algorithm).
    """

    def __init__(self, engine, *, domain: int | None = None,
                 force_algo: str | None = None,
                 positional: int | None = None,
                 term_map: dict[str, int] | None = None, B: int = 8,
                 stats: ListStats | None = None):
        self.engine = engine
        self.stride = positional
        if positional is not None and domain is None:
            domain = -(-engine.res.universe // positional)  # ceil
        self.stats = (stats if stats is not None
                      else ListStats.from_engine(engine, B=B, domain=domain))
        self.force_algo = force_algo
        self.term_map = term_map

    # -- public API ----------------------------------------------------------

    def search(self, q: str | Node) -> np.ndarray:
        return self.run_plan(self.plan(q))

    def plan(self, q: str | Node) -> PlanNode:
        node = parse(q, self.term_map) if isinstance(q, str) else q
        return make_plan(node, self.stats, self.force_algo,
                         probe_terms=self.stride is None)

    def topk(self, q, k: int, *, prune: bool = True):
        """Ranked top-k retrieval (DESIGN.md §9): the query — a string, an
        AST node, or a plain term-id bag — is flattened to its bag of
        words and driven through the block-max MaxScore machine
        (``topk.lower_topk``) on this executor's engine.  Returns a
        :class:`~repro_torch.query.topk.RankedResult`."""
        from .topk import lower_topk
        return drive(lower_topk(self.engine.score_index,
                                self.query_terms(q), k, prune=prune),
                     self.engine)

    def query_terms(self, q) -> list[int]:
        """Bag of words of a query in any accepted form (string / AST /
        term-id sequence) — ranked retrieval ignores boolean structure."""
        if isinstance(q, str):
            return terms_of(parse(q, self.term_map))
        if isinstance(q, (And, Or, Not, Phrase, Term)):
            return terms_of(q)
        return [int(t) for t in q]

    def lower(self, plan: PlanNode):
        """The plan as a resumable step machine (DESIGN.md §8.1): a
        generator yielding typed steps, returning the result array."""
        return self._lower(plan)

    def run_plan(self, plan: PlanNode) -> np.ndarray:
        out = np.asarray(drive(self.lower(plan), self.engine),
                         dtype=np.int64)
        # bare-Term plans alias the engine's frozen decode cache; hand the
        # caller a writable array without copying on the common paths
        return out if out.flags.writeable else out.copy()

    # -- lowering ------------------------------------------------------------

    def _term_docs(self, t: int):
        if not self.stats.valid(t):
            return _EMPTY
        arr = yield DecodeList(t)
        if self.stride is not None:
            return np.unique(np.asarray(arr, np.int64) // self.stride)
        return arr

    def _probe_keep(self, t: int, probes: np.ndarray, algo: str):
        """Boolean membership of ``probes`` in list ``t`` via one probe
        round of the chosen engine primitive."""
        if probes.size == 0:
            return np.zeros(0, dtype=bool)
        if not self.stats.valid(t):
            return np.zeros(probes.size, dtype=bool)
        lids = np.full(probes.size, t, dtype=np.int32)
        vals = yield ProbeRound(lids, probes.astype(np.int32), algo)
        return np.asarray(vals, np.int64) == probes

    def _lower(self, p: PlanNode):
        if p.op == "term":
            return (yield from self._term_docs(p.node.t))
        if p.op == "not":
            child = yield from self._lower(p.children[0])
            return (yield SetOp("complement", child, self.stats.domain))
        if p.op == "or":
            outs = yield from self._lower_parallel(p.children)
            out = _EMPTY
            for r in outs:
                out = yield SetOp("union", out, r)
            return out
        if p.op == "phrase" and self.stride is not None:
            return (yield from self._lower_phrase(p))
        # and / doc-level phrase (conjunction skeleton)
        if p.meld:
            ts = [c.node.t for c in p.children]
            if not all(self.stats.valid(t) for t in ts):
                return _EMPTY
            return (yield from self._lower_meld(ts))
        return (yield from self._lower_conjunction(p))

    def _lower_parallel(self, plans):
        """Advance independent child machines in lockstep; pending probe
        rounds of the same algorithm merge into one yielded
        :class:`ProbeRound` (intra-query coalescing — the same
        concatenate/scatter convention the cross-query scheduler uses)."""
        machines = [self._lower(p) for p in plans]
        results: list = [None] * len(machines)
        pending: dict[int, ProbeRound] = {}
        for i, m in enumerate(machines):
            kind, val = yield from _until_probe(m, _PRIME)
            if kind == "done":
                results[i] = val
            else:
                pending[i] = val
        while pending:
            for algo in ("svs", "bys"):
                group = [i for i in sorted(pending)
                         if pending[i].algo == algo]
                if not group:
                    continue
                rounds = [pending.pop(i) for i in group]
                vals = yield ProbeRound(
                    np.concatenate([r.list_ids for r in rounds]),
                    np.concatenate([r.xs for r in rounds]), algo)
                vals, off = np.asarray(vals), 0
                for i, r in zip(group, rounds):
                    seg = vals[off:off + r.size]
                    off += r.size
                    kind, v = yield from _until_probe(machines[i], seg)
                    if kind == "done":
                        results[i] = v
                    else:
                        pending[i] = v
        return results

    def _lower_conjunction(self, p: PlanNode):
        assert p.steps, "conjunction without lowering steps"
        cand = yield from self._lower(p.children[p.steps[0][0]])
        for pos, algo in p.steps[1:]:
            if cand.size == 0:
                break
            child = p.children[pos]
            # probe steps need a compressed list on the right AND doc-level
            # addressing (positional lists hold positions, not docs)
            if (child.op == "term" and self.stride is None
                    and algo in ("svs", "bys")):
                keep = yield from self._probe_keep(child.node.t, cand, algo)
                cand = yield SetOp("filter", cand, keep)
            else:
                other = yield from self._lower(child)
                cand = yield SetOp("intersect", cand, other)
        return cand

    def _lower_meld(self, idxs):
        """K-way adaptive melding as probe rounds: all k cursors chase a
        common frontier — one :class:`ProbeRound` advances every list to
        the current candidate, the maximum answer becomes the next
        candidate, agreement emits an element.  Bit-identical to
        ``Engine.intersect_multi_meld`` (same primitive, same rounds) but
        lowered here so a suspended meld coalesces with other queries."""
        idxs = [int(i) for i in idxs]
        if not idxs:
            return _EMPTY
        if len(idxs) == 1:
            return (yield from self._term_docs(idxs[0]))
        lids = np.asarray(idxs, dtype=np.int32)
        inf = int(INT_INF)
        out: list[int] = []
        x = 0
        while True:
            vals = yield ProbeRound(
                lids, np.full(lids.size, x, dtype=np.int32), "svs")
            vals = np.asarray(vals, np.int64)
            m = int(vals.max())
            if m >= inf:        # some list is exhausted — no more matches
                break
            if int(vals.min()) == m:
                out.append(m)
                x = m + 1
            else:
                x = m
        return np.asarray(out, dtype=np.int64)

    def _lower_phrase(self, p: PlanNode):
        """Intersect shifted position lists; each step probes the
        candidate phrase-start positions shifted to that term's offset."""
        node: Phrase = p.node
        k = len(node.terms)
        seed_off = p.steps[0][0]
        seed = yield from self._positions(node.terms[seed_off])
        cand = yield PhraseShift(seed, seed_off)   # phrase-start positions
        for pos, algo in p.steps[1:]:
            if cand.size == 0:
                break
            t = node.terms[pos]
            probes = cand + pos
            if algo == "merge" or not self.stats.valid(t):
                plist = yield from self._positions(t)
                keep = np.isin(probes, plist, assume_unique=True)
            else:
                keep = yield from self._probe_keep(t, probes, algo)
            cand = yield SetOp("filter", cand, keep)
        # a phrase window must not straddle a document boundary
        return (yield PhraseShift(cand, stride=self.stride, k=k))

    def _positions(self, t: int):
        if not self.stats.valid(t):
            return _EMPTY
        arr = yield DecodeList(t)
        return arr


def naive_eval(node: Node, lists: list[np.ndarray], domain: int,
               stride: int | None = None) -> np.ndarray:
    """The differential oracle: pure numpy set algebra over the RAW
    postings lists (no grammar, no engine, no planner).  Phrase semantics
    mirror the executor: positional window intersection when ``stride`` is
    given, conjunction otherwise."""
    from .ast import And, Not, Or  # local: avoid polluting module surface

    def docs(t: int) -> np.ndarray:
        if not (0 <= t < len(lists)):
            return _EMPTY
        arr = np.asarray(lists[t], np.int64)
        return np.unique(arr // stride) if stride is not None else arr

    if isinstance(node, Term):
        return docs(node.t)
    if isinstance(node, Not):
        return np.setdiff1d(np.arange(domain, dtype=np.int64),
                            naive_eval(node.child, lists, domain, stride),
                            assume_unique=True)
    if isinstance(node, Or):
        out = _EMPTY
        for c in node.children:
            out = np.union1d(out, naive_eval(c, lists, domain, stride))
        return out
    if isinstance(node, And):
        out = None
        for c in node.children:
            r = naive_eval(c, lists, domain, stride)
            out = r if out is None else np.intersect1d(out, r,
                                                       assume_unique=True)
        return out if out is not None else _EMPTY
    if isinstance(node, Phrase):
        if stride is None:
            return naive_eval(And(tuple(Term(t) for t in node.terms)),
                              lists, domain)
        cand = None
        for off, t in enumerate(node.terms):
            if not (0 <= t < len(lists)):
                return _EMPTY
            starts = np.asarray(lists[t], np.int64) - off
            starts = starts[starts >= 0]
            cand = starts if cand is None else np.intersect1d(cand, starts)
        ok = (cand % stride) + len(node.terms) <= stride
        return np.unique(cand[ok] // stride)
    raise TypeError(f"not a query node: {node!r}")
