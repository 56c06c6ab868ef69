"""The port's streaming ingestion against the JAX package's
(``tests/test_segment.py``).

The gate, held at every step: **interleaved insert/search equals a
rebuild from scratch** — boolean answers equal the numpy set oracle over
the whole current corpus, ranked top-k answers equal ``rank_oracle``
exactly (scores and order) — on every port engine: ``host``, ``torch``
flat and paged at page 128, and ``cuda`` (on the CPU, its kernels' plain
versions), with flushes and background compactions landing between the
checks.  Beside each port server runs ``repro``'s ``QueryServer`` (its
host engine) over the same documents: the same answers, the same segment
layout (bases, sizes, generations) and the same ``telemetry()`` (but the
flush milliseconds, which are the host's time).

Plus the crash and restart pins of ``tests/test_segment.py`` on every
engine: the delta tier replays from the one-integer log cursor, a killed
flush leaves the previous segment set serving, compaction replays to the
same layout; the delta-budget env, the telemetry, the result cache keyed
on the content epoch, ``swap_index`` detaching the manager, and every
round of a segment dispatched on that segment's own engine.  The gate
also runs list-sharded (torch and cuda engines with a mesh of 1 and 2
CPU shards, ``test_segment.py:108``): every segment engine is sharded.
"""

import os

import numpy as np
import pytest

from repro.build import make_builder as make_builder_jax
from repro.engine import make_engine as make_engine_jax
from repro.query import ast as JA
from repro.query.steps import ProbeRound as ProbeRoundJax
from repro.query.steps import ScoreRound as ScoreRoundJax
from repro.segment import SegmentedIndex as SegmentedJax
from repro.serve.query_serve import QueryServer as ServerJax

from repro_torch.build import make_builder
from repro_torch.data import PostingsSource
from repro_torch.engine import make_engine
from repro_torch.query import naive_eval, parse, rank_oracle
from repro_torch.query.ast import And, Not, Or, Term
from repro_torch.query.steps import ProbeRound, ScoreRound
from repro_torch.segment import DELTA_BUDGET_ENV, SegmentedIndex
from repro_torch.serve import QueryServer

SEED = int(os.environ.get("REPRO_BENCH_SEED", "0"))
VOCAB = 64
PAGE = 128

#: QueryServer / make_engine keywords of each port engine configuration
CONFIGS = {
    "host": {},
    "torch": {"device": "cpu"},
    "torch_paged": {"device": "cpu", "paged": True, "page_size": PAGE},
    "cuda": {"device": "cpu", "page_size": PAGE},
}


def _engine_name(name):
    return "torch" if name == "torch_paged" else name


def _corpus(n, seed=SEED):
    """Coverage corpus: doc 0 holds every term, so global term id ==
    dense list index and the rebuilt-from-scratch universe equals the
    doc count on both sides of the gate."""
    src = PostingsSource(base_docs=16, growth_docs=8, vocab=VOCAB,
                         mean_doc_len=12, seed=seed + 17)
    return [np.arange(VOCAB, dtype=np.int64)] + \
        [src.doc_terms(d) for d in range(n - 1)]


def _invert(docs):
    inv = {}
    for d, terms in enumerate(docs):
        for t in terms.tolist():
            inv.setdefault(int(t), []).append(d)
    return [np.asarray(inv[t], np.int64) for t in sorted(inv)]


def _queries(rng):
    a, b, c = (int(t) for t in rng.choice(VOCAB, 3, replace=False))
    return [And((Term(a), Term(b))),
            Or((Term(a), Not(Term(c)))),
            And((Term(a), Not(And((Term(b), Term(c))))))]


def _jax_node(node):
    """The same query as the JAX package's AST."""
    if isinstance(node, Term):
        return JA.Term(node.t)
    if isinstance(node, Not):
        return JA.Not(_jax_node(node.child))
    kind = JA.And if isinstance(node, And) else JA.Or
    return kind(tuple(_jax_node(c) for c in node.children))


def _server(res, name, **extra):
    return QueryServer(res, max_short_len=64, engine=_engine_name(name),
                       **CONFIGS[name], **extra)


def _layout(segments):
    return [(s.base, s.num_docs, s.gen) for s in segments]


def _telemetry(t):
    assert t["flushes"] == 0 or t["flush_ms"] > 0
    return {k: v for k, v in t.items() if k != "flush_ms"}


# -- the interleaved == rebuild gate, all engines, beside repro --------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_interleaved_equals_rebuild_every_step(name):
    docs = _corpus(56)
    base = _invert(docs[:24])
    srv = _server(make_builder("host").build_grammar(base), name)
    ref = ServerJax(make_builder_jax("host").build_grammar(base),
                    max_short_len=64, engine="host")
    srv.enable_ingest(delta_budget=6, compact_fanout=2)
    ref.enable_ingest(delta_budget=6, compact_fanout=2)
    rng = np.random.default_rng(SEED + 1)
    for i, d in enumerate(docs[24:]):
        assert srv.insert(d) == ref.insert(d) == 24 + i
        cur = docs[:25 + i]
        lists, n = _invert(cur), len(cur)
        qs = _queries(rng)
        for q, got, other in zip(qs, srv.search_many(qs),
                                 ref.search_many([_jax_node(q)
                                                  for q in qs])):
            np.testing.assert_array_equal(got, naive_eval(q, lists, n))
            np.testing.assert_array_equal(got, other)
        ts = sorted(int(t) for t in rng.choice(VOCAB, 4, replace=False))
        rr, rj = srv.search_topk(ts, 10), ref.search_topk(ts, 10)
        od, osc = rank_oracle(lists, n, ts, 10)
        np.testing.assert_array_equal(rr.docs, od)
        np.testing.assert_array_equal(rr.scores, osc)
        np.testing.assert_array_equal(rr.docs, rj.docs)
        np.testing.assert_array_equal(rr.scores, rj.scores)
        assert _layout(srv.segmented.segments) == \
            _layout(ref.segmented.segments)
        assert _telemetry(srv.segmented.telemetry()) == \
            _telemetry(ref.segmented.telemetry())
    st = srv.serve_stats()
    assert st["flushes"] >= 3 and st["segments"] >= 2, st
    assert st["compactions"] >= 1, st       # background merges ran
    assert st["ingested_docs"] == 32, st


@pytest.mark.parametrize("name", ["torch", "cuda"])
@pytest.mark.parametrize("shards", [1, 2])
def test_interleaved_equals_rebuild_sharded(shards, name):
    """The same gate through the list-sharded dispatch
    (``tests/test_segment.py:108``): every segment engine the server makes
    is sharded over the mesh, and every step equals the oracle and
    ``repro``'s server, layout and telemetry included."""
    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    docs = _corpus(40)
    base = _invert(docs[:28])
    srv = _server(make_builder("host").build_grammar(base), name,
                  mesh=Mesh(["cpu"] * shards))
    ref = ServerJax(make_builder_jax("host").build_grammar(base),
                    max_short_len=64, engine="host")
    srv.enable_ingest(delta_budget=5, compact_fanout=2)
    ref.enable_ingest(delta_budget=5, compact_fanout=2)
    rng = np.random.default_rng(SEED + 2)
    D.reset_dispatches()
    for i, d in enumerate(docs[28:]):
        assert srv.insert(d) == ref.insert(d)
        cur = docs[:29 + i]
        lists, n = _invert(cur), len(cur)
        qs = _queries(rng)
        for q, got, other in zip(qs, srv.search_many(qs, "svs"),
                                 ref.search_many([_jax_node(q)
                                                  for q in qs])):
            np.testing.assert_array_equal(got, naive_eval(q, lists, n))
            np.testing.assert_array_equal(got, other)
        ts = sorted(int(t) for t in rng.choice(VOCAB, 3, replace=False))
        rr = srv.search_topk(ts, 8)
        od, osc = rank_oracle(lists, n, ts, 8)
        np.testing.assert_array_equal(rr.docs, od)
        np.testing.assert_array_equal(rr.scores, osc)
        assert _layout(srv.segmented.segments) == \
            _layout(ref.segmented.segments)
    engines = [s.engine for s in srv.segmented.segments
               if s.engine is not None]
    assert len(engines) >= 2
    for eng in engines:
        assert len(eng._sharded_next_geq.shards) == shards
    assert D.DISPATCHES["sharded_next_geq"] > 0
    assert srv.serve_stats()["compactions"] >= 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_result_cache_correct_across_inserts(name):
    """Result keys fold in the content epoch: an insert must invalidate,
    a flush (content-preserving) must NOT."""
    docs = _corpus(32)
    srv = _server(make_builder("host").build_grammar(_invert(docs[:24])),
                  name)
    srv.enable_ingest(delta_budget=100, compact_fanout=2)
    q = "(0 AND 1) OR NOT 2"
    node = parse(q, None)
    srv.insert(docs[24])
    first = srv.search(q)
    h0 = srv.serve_stats()["result_cache"]["hits"]
    np.testing.assert_array_equal(srv.search(q), first)
    assert srv.serve_stats()["result_cache"]["hits"] == h0 + 1
    srv.flush()
    np.testing.assert_array_equal(srv.search(q), first)
    assert srv.serve_stats()["result_cache"]["hits"] == h0 + 2
    srv.insert(docs[25])
    lists, n = _invert(docs[:26]), 26
    np.testing.assert_array_equal(srv.search(q),
                                  naive_eval(node, lists, n))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rounds_dispatch_on_their_segments_engine(name):
    """Every ProbeRound and ScoreRound of a segment runs on that segment's
    engine, with the segment's own (local) list ids; the flushed segments
    are engines of the serving configuration."""
    docs = _corpus(48)
    srv = _server(make_builder("host").build_grammar(_invert(docs[:24])),
                  name)
    seg = srv.enable_ingest(delta_budget=5, compact_fanout=8)
    for d in docs[24:]:
        srv.insert(d)
    assert len(seg.segments) >= 4 and seg.compactions == 0
    seen = {}
    for s in seg.segments:
        assert type(s.engine) is type(srv.engine)
        assert getattr(s.engine, "device", None) == \
            getattr(srv.engine, "device", None)

        def probe(list_ids, xs, algo, _f=s.engine.dispatch_round, _s=s):
            assert np.asarray(list_ids).max() < _s.terms.size
            seen[_s.version] = seen.get(_s.version, 0) + 1
            return _f(list_ids, xs, algo)

        def score(entries, _f=s.engine.dispatch_score_round, _s=s):
            seen[_s.version] = seen.get(_s.version, 0) + 1
            return _f(entries)
        s.engine.dispatch_round = probe
        s.engine.dispatch_score_round = score
    rng = np.random.default_rng(SEED + 6)
    lists, n = _invert(docs), len(docs)
    qs = [And((Term(0), Term(int(t)))) for t in rng.choice(VOCAB, 6)]
    for q, got in zip(qs, srv.search_many(qs, force_algo="svs")):
        np.testing.assert_array_equal(got, naive_eval(q, lists, n))
    rr = srv.search_topk([0, 1, 2, 3], 10)
    od, osc = rank_oracle(lists, n, [0, 1, 2, 3], 10)
    np.testing.assert_array_equal(rr.docs, od)
    np.testing.assert_array_equal(rr.scores, osc)
    assert set(seen) == {s.version for s in seg.segments}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_single_posting_lists_segment(name):
    """A segment flushed from one document holds only single-posting
    lists: its Re-Pair stream is empty.  Every engine serves it exactly
    (the device engines pad the empty stream with one terminal no list
    reads; repro's jnp and pallas engines fail on such an index)."""
    docs = _corpus(30)
    srv = _server(make_builder("host").build_grammar(_invert(docs[:24])),
                  name)
    srv.enable_ingest(delta_budget=100)
    srv.insert(docs[24])
    segment = srv.flush()
    assert segment.res.seq.size == 0
    lists, n = _invert(docs[:25]), 25
    rng = np.random.default_rng(SEED + 7)
    qs = _queries(rng)
    for q, got in zip(qs, srv.search_many(qs)):
        np.testing.assert_array_equal(got, naive_eval(q, lists, n))
    ts = sorted(int(t) for t in docs[24][:3])
    rr = srv.search_topk(ts, 10)
    od, osc = rank_oracle(lists, n, ts, 10)
    np.testing.assert_array_equal(rr.docs, od)
    np.testing.assert_array_equal(rr.scores, osc)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_lists_equals_decode_list(name):
    """The batched decode the segment tier uses (a segment's whole
    vocabulary, lists of many widths, some already cached) returns
    ``decode_list``'s arrays, frozen, and the postings themselves."""
    docs = _corpus(200)
    lists = _invert(docs)
    res = make_builder("host").build_grammar(lists)
    eng, ref = _factory(name)(res), _factory(name)(res)
    cached = [eng.decode_list(i) for i in range(0, len(lists), 7)]
    got = eng.decode_lists(range(len(lists)))
    assert len({(len(l) - 1).bit_length() for l in lists}) >= 4
    for i, arr in enumerate(got):
        np.testing.assert_array_equal(arr, ref.decode_list(i))
        np.testing.assert_array_equal(arr, lists[i])
        assert not arr.flags.writeable
    for k, arr in enumerate(cached):
        assert got[7 * k] is arr


# -- crash/restart semantics -------------------------------------------------

def _drive(machine):
    """Run a step machine of either package to its answer."""
    try:
        step = next(machine)
        while True:
            if isinstance(step, (ProbeRound, ProbeRoundJax)):
                r = step.engine.dispatch_round(step.list_ids, step.xs,
                                               step.algo)
            elif isinstance(step, (ScoreRound, ScoreRoundJax)):
                r = step.engine.dispatch_score_round(step.entries)
            else:
                r = step.run()
            step = machine.send(r)
    except StopIteration as s:
        return s.value


def _factory(name):
    kw = dict(CONFIGS[name], **({} if name == "host" else
                                {"max_short_len": 64}))
    return lambda r: make_engine(_engine_name(name), r, **kw)


def _manager(docs, n_base, name, **kw):
    res = make_builder("host").build_grammar(_invert(docs[:n_base]))
    return SegmentedIndex(res, _factory(name)(res), _factory(name),
                          builder="host", **kw)


def _manager_jax(docs, n_base, **kw):
    res = make_builder_jax("host").build_grammar(_invert(docs[:n_base]))
    return SegmentedJax(res, make_engine_jax("host", res),
                        lambda r: make_engine_jax("host", r),
                        builder="host", **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_delta_replays_from_cursor(name):
    """The delta tier is a pure function of the mutation log past the
    one-integer cursor: replaying it into a fresh manager reproduces the
    answers exactly."""
    docs = _corpus(40)
    seg = _manager(docs, 20, name, delta_budget=8)
    for d in docs[20:]:
        seg.insert(d)
    assert seg.delta_docs > 0
    replay = _manager(docs, 20, name, delta_budget=10_000)
    for i in range(len(docs) - 20):
        replay.insert(seg.log_entry(i))
    assert replay.delta_docs == len(docs) - 20
    rng = np.random.default_rng(SEED + 3)
    lists, n = _invert(docs), len(docs)
    for q in _queries(rng):
        want = naive_eval(q, lists, n)
        np.testing.assert_array_equal(_drive(seg.lower_bool(q)), want)
        np.testing.assert_array_equal(_drive(replay.lower_bool(q)), want)
    ts = sorted(int(t) for t in rng.choice(VOCAB, 4, replace=False))
    a, b = _drive(seg.lower_topk(ts, 10)), _drive(replay.lower_topk(ts, 10))
    np.testing.assert_array_equal(a.docs, b.docs)
    np.testing.assert_array_equal(a.scores, b.scores)
    od, osc = rank_oracle(lists, n, ts, 10)
    np.testing.assert_array_equal(a.docs, od)
    np.testing.assert_array_equal(a.scores, osc)


class _KilledFlush(RuntimeError):
    pass


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flush_is_atomic_under_crash(name):
    """A flush killed mid-build (builder raises) leaves the previous
    (segments, cursor) pair serving, and a retry succeeds from the intact
    log."""
    docs = _corpus(36)
    seg = _manager(docs, 20, name, delta_budget=10_000)
    for d in docs[20:]:
        seg.insert(d)
    segs0, cursor0, delta0 = seg.segments, seg.cursor, seg.delta_docs

    class _Bomb:
        def build_grammar(self, lists):
            raise _KilledFlush("killed mid-flush")
    good_builder, seg._builder = seg._builder, _Bomb()
    with pytest.raises(_KilledFlush):
        seg.flush()
    assert seg.segments is segs0
    assert seg.cursor == cursor0 and seg.delta_docs == delta0
    rng = np.random.default_rng(SEED + 4)
    lists, n = _invert(docs), len(docs)
    for q in _queries(rng):
        np.testing.assert_array_equal(_drive(seg.lower_bool(q)),
                                      naive_eval(q, lists, n))
    seg._builder = good_builder
    assert seg.flush() is not None
    assert seg.delta_docs == 0
    for q in _queries(np.random.default_rng(SEED + 4)):
        np.testing.assert_array_equal(_drive(seg.lower_bool(q)),
                                      naive_eval(q, lists, n))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compaction_idempotent_on_replay(name):
    """Compaction is a pure function of the immutable segment contents:
    replaying it converges to the same layout as running it to
    quiescence, and to repro's layout on the same documents."""
    docs = _corpus(44)

    def build(make):
        seg = make(docs, 16, delta_budget=4, compact_fanout=2)
        for d in docs[16:]:
            seg.insert(d)
        return seg
    a = build(lambda *x, **k: _manager(*x, name, **k))
    b = build(lambda *x, **k: _manager(*x, name, **k))
    j = build(_manager_jax)
    a.compact()
    b.compact_step()
    while b.compact_step():
        pass
    j.compact()
    assert _layout(a.segments) == _layout(b.segments) == _layout(j.segments)
    assert a.compact_step() is False
    rng = np.random.default_rng(SEED + 5)
    lists, n = _invert(docs), len(docs)
    for q in _queries(rng):
        want = naive_eval(q, lists, n)
        np.testing.assert_array_equal(_drive(a.lower_bool(q)), want)
        np.testing.assert_array_equal(_drive(b.lower_bool(q)), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_blank_segments_compact(name):
    """Runs of termless documents flush as blank segments (no engine, no
    lists); compaction merges them with indexed segments and with each
    other, to repro's layout, telemetry and answers."""
    docs = _corpus(36)
    blank = np.empty(0, np.int64)
    stream = (docs[16:21] + [blank] * 5 + docs[21:26] + [blank] * 10
              + docs[26:36])
    kw = dict(delta_budget=4, compact_fanout=2)
    seg, jseg = _manager(docs, 16, name, **kw), _manager_jax(docs, 16, **kw)
    blanks = 0
    for d in stream:
        seg.insert(d)
        jseg.insert(d)
        blanks = max(blanks, sum(s.engine is None for s in seg.segments))
    assert blanks >= 1
    seg.compact()
    jseg.compact()
    assert seg.compactions >= 2
    assert _layout(seg.segments) == _layout(jseg.segments)
    assert _telemetry(seg.telemetry()) == _telemetry(jseg.telemetry())
    cur = docs[:16] + stream
    lists, n = _invert(cur), len(cur)
    rng = np.random.default_rng(SEED + 8)
    for q in _queries(rng):
        got = _drive(seg.lower_bool(q))
        np.testing.assert_array_equal(got, naive_eval(q, lists, n))
        np.testing.assert_array_equal(got, _drive(jseg.lower_bool(
            _jax_node(q))))
    ts = sorted(int(t) for t in rng.choice(VOCAB, 4, replace=False))
    got = _drive(seg.lower_topk(ts, 10))
    od, osc = rank_oracle(lists, n, ts, 10)
    np.testing.assert_array_equal(got.docs, od)
    np.testing.assert_array_equal(got.scores, osc)


# -- knobs + telemetry -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_delta_budget_env(monkeypatch, name):
    docs = _corpus(24)
    monkeypatch.setenv(DELTA_BUDGET_ENV, "3")
    seg = _manager(docs, 16, name)
    jseg = _manager_jax(docs, 16)
    assert seg.delta_budget == jseg.delta_budget == 3
    for d in docs[16:24]:
        seg.insert(d)
        jseg.insert(d)
    assert seg.flushes >= 1
    assert seg.delta_docs <= 3
    assert _layout(seg.segments) == _layout(jseg.segments)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_telemetry_counts(name):
    docs = _corpus(40)
    seg = _manager(docs, 16, name, delta_budget=4, compact_fanout=2)
    jseg = _manager_jax(docs, 16, delta_budget=4, compact_fanout=2)
    for d in docs[16:]:
        seg.insert(d)
        jseg.insert(d)
    seg.compact()
    jseg.compact()
    t = seg.telemetry()
    assert t["ingested_docs"] == 24
    assert t["flushes"] >= 2 and t["flush_ms"] > 0
    assert t["compactions"] >= 1
    assert t["segments"] == len(seg.segments)
    assert t["delta_docs"] == seg.delta_docs
    assert _telemetry(t) == _telemetry(jseg.telemetry())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_swap_index_detaches_segmented(name):
    """A full-index hot swap supersedes the segment manager (it wrapped
    the old engine); serving continues on the new index."""
    docs = _corpus(30)
    bld = make_builder("host")
    srv = _server(bld.build_grammar(_invert(docs[:24])), name)
    srv.insert(docs[24])
    assert srv.segmented is not None
    lists, n = _invert(docs[:26]), 26
    srv.swap_index(bld.build_grammar(lists))
    assert srv.segmented is None and srv.scheduler.segmented is None
    q = And((Term(0), Term(1)))
    np.testing.assert_array_equal(srv.search(q), naive_eval(q, lists, n))
