"""The port's span recorder (``repro_torch.obs``) and the spans of the
serving path and the build.

* off, ``span`` hands back one shared object, reads no clock, allocates
  nothing and records nothing;
* on, records nest with their parents' indices, carry the query, tick and
  step ids, and close on an exception; ``drain`` clears them and refuses
  inside an open span;
* a CPU ``QueryServer`` run with recording on records every span of the
  serving path and the build, nested as the scheduler calls them, and
  answers bit for bit as with recording off and as the set oracle.
"""

import dis
import inspect
import itertools
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.build import make_builder
from repro_torch.index.corpus import zipf_corpus
from repro_torch.launch.serve import boolean_workload
from repro_torch.query import naive_eval
from repro_torch.serve import QueryServer

SERVING = ("query.submit", "scheduler.tick", "scheduler.advance",
           "query.host_step", "engine.expand", "engine.dispatch_round",
           "device.sync")


@pytest.fixture(autouse=True)
def clean_recorder():
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def _spans_off(n: int) -> None:
    for _ in itertools.repeat(None, n):
        with obs.span("scheduler.advance", qid=7):
            pass
        with obs.span("query.host_step", op="union"):
            pass


def _held_after(fn, n: int) -> int:
    """Bytes still held after ``fn(n)``, under ``tracemalloc``."""
    fn(8)
    tracemalloc.start()
    try:
        cur0, _ = tracemalloc.get_traced_memory()
        fn(n)
        cur, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return cur - cur0


def _off_path(fn) -> list[str]:
    """The instructions ``fn`` runs up to its first return."""
    out = []
    for ins in dis.get_instructions(fn):
        out.append(ins.opname)
        if ins.opname.startswith("RETURN"):
            return out
    raise AssertionError(f"{fn.__qualname__} has no return")


def test_off_returns_one_shared_object_and_records_nothing():
    a = obs.span("query.submit", qid=1)
    b = obs.span("scheduler.tick", tick=2)
    c = obs.span("query.host_step", op="union")
    assert a is b is c
    with a as entered:
        assert entered is a
    assert obs.drain() == []


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    def clock():
        raise AssertionError("the clock was read with recording off")
    monkeypatch.setattr(obs, "time", SimpleNamespace(perf_counter_ns=clock))
    assert _held_after(_spans_off, 20000) == 0
    assert obs.drain() == []
    # off, ``span`` tests the flag and returns the shared object: no call,
    # no object built; its ids are named parameters, so a call with ids
    # builds no dictionary either; entering and leaving build nothing
    for fn in (obs.span, type(obs.span("x")).__enter__,
               type(obs.span("x")).__exit__):
        ran = _off_path(fn)
        assert not [op for op in ran
                    if op.startswith(("CALL", "BUILD", "MAKE"))], ran
    assert not obs.span.__code__.co_flags & inspect.CO_VARKEYWORDS
    # the same clock, once recording is on, is read
    obs.enable()
    with pytest.raises(AssertionError, match="clock"):
        with obs.span("scheduler.tick", tick=1):
            pass


def test_nesting_parents_and_ids():
    obs.enable()
    with obs.span("scheduler.tick", tick=3):
        with obs.span("scheduler.advance", qid=11):
            with obs.span("query.host_step", op="intersect"):
                pass
        with obs.span("engine.dispatch_round"):
            obs.to_host(torch.arange(4))
    with obs.span("query.submit", qid=12):
        pass
    recs = obs.drain()
    names = [r[0] for r in recs]
    assert names == ["scheduler.tick", "scheduler.advance",
                     "query.host_step", "engine.dispatch_round",
                     "device.sync", "query.submit"]
    assert [r[3] for r in recs] == [-1, 0, 1, 0, 3, -1]
    assert [r[4] for r in recs] == [{"tick": 3}, {"qid": 11},
                                    {"op": "intersect"}, {}, {}, {"qid": 12}]
    for name, t0, t1, parent, _ in recs:
        assert t0 <= t1
        if parent >= 0:       # a child lies inside its parent
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]
    # self time: the tick's duration less its two children's
    tick, adv, rnd = recs[0], recs[1], recs[3]
    self_ns = (tick[2] - tick[1]) - (adv[2] - adv[1]) - (rnd[2] - rnd[1])
    assert 0 <= self_ns <= tick[2] - tick[1]
    assert obs.drain() == []


def test_spans_close_on_an_exception_and_drain_refuses_inside_one():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("scheduler.tick", tick=1):
            with obs.span("scheduler.advance", qid=0):
                raise ValueError("poisoned query")
    recs = obs.drain()
    assert [r[0] for r in recs] == ["scheduler.tick", "scheduler.advance"]
    assert all(r[2] is not None for r in recs)
    with obs.span("scheduler.tick", tick=2):
        with pytest.raises(RuntimeError, match="open span"):
            obs.drain()
    assert [r[3] for r in obs.drain()] == [-1]
    # what was recorded before ``disable`` stays for the drain
    with obs.span("query.submit", qid=1):
        obs.disable()
    assert [r[0] for r in obs.drain()] == ["query.submit"]


def test_to_host_copies_bit_for_bit():
    t = torch.tensor([3, -1, 2147483647], dtype=torch.int32)
    got = obs.to_host(t)
    assert got.dtype == np.int32 and got.tolist() == [3, -1, 2147483647]
    obs.enable()
    got = obs.to_host(t.reshape(3, 1))
    assert got.shape == (3, 1)
    assert [r[0] for r in obs.drain()] == ["device.sync"]


@pytest.fixture(scope="module")
def small():
    lists = zipf_corpus(num_docs=300, vocab_size=400, mean_doc_len=30,
                        seed=3).postings()
    lengths = [len(l) for l in lists]
    queries = boolean_workload(len(lists), lengths, n_queries=48, seed=3,
                               p_or=0.35, p_not=0.25, p_phrase=0.1)
    return lists, queries


def _serve(res, queries, engine):
    """Each query through ``submit`` and the tick loop, four in flight."""
    srv = QueryServer(res, engine=engine, device="cpu", batch_window=4)
    sched = srv.scheduler
    qids = []
    for k in range(0, len(queries), 6):
        qids += [srv.submit(q) for q in queries[k:k + 6]]
        sched.tick()
    sched.drain()
    return qids, [sched.take(q) for q in qids], sched.stats()


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_server_spans_on_the_cpu(small, engine):
    lists, queries = small
    obs.enable()
    res = make_builder("torch", device="cpu").build_grammar(lists)
    qids, on, stats = _serve(res, queries, engine)
    recs = obs.drain()
    obs.disable()
    _, off, _ = _serve(res, queries, engine)
    assert obs.drain() == []

    domain = max(int(l.max()) for l in lists if len(l)) + 1
    for q, a, b in zip(queries, on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(a, naive_eval(q, lists, domain))

    names = [r[0] for r in recs]
    assert set(names) == set(SERVING) | {"build.grammar"}
    assert names[0] == "build.grammar" and names.count("build.grammar") == 1

    def ancestors(i):
        out = []
        while recs[i][3] >= 0:
            i = recs[i][3]
            out.append(recs[i][0])
        return out

    for i, (name, _, _, parent, ids) in enumerate(recs):
        up = ancestors(i)
        if name == "query.submit":
            assert parent == -1 and set(ids) == {"qid"}
        elif name == "scheduler.tick":
            assert parent == -1 and set(ids) == {"tick"}
        elif name == "scheduler.advance":
            assert up == ["scheduler.tick"] and set(ids) == {"qid"}
        elif name == "engine.expand":
            assert up[:1] == ["scheduler.advance"]
            assert up[-1] == "scheduler.tick"
        elif name == "engine.dispatch_round":
            assert up == ["scheduler.tick"]
        elif name == "query.host_step":
            assert up[0] == "scheduler.advance" and set(ids) == {"op"}
        elif name == "device.sync":
            assert up[0] in ("engine.expand", "engine.dispatch_round")
    # one submit span per query, its id the query's; ticks count up
    assert sorted(r[4]["qid"] for r in recs
                  if r[0] == "query.submit") == sorted(qids)
    ticks = [r[4]["tick"] for r in recs if r[0] == "scheduler.tick"]
    assert ticks == list(range(1, len(ticks) + 1))
    advanced = {r[4]["qid"] for r in recs if r[0] == "scheduler.advance"}
    assert advanced <= set(qids)
    # every list the engine's LRU missed was expanded inside a span
    assert stats["engine_decode_cache"]["misses"] >= names.count(
        "engine.expand") > 0
