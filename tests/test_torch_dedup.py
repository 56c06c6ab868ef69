"""Hot-path dedup gates of the port (``tests/test_dedup.py``).

Cross-query lane dedup, the version-keyed probe memo and overlapped page
prefetch must be invisible in results: every (dedup, memo) on/off
combination returns exactly the serial all-off path's answers on every
port engine — ``host``, ``torch`` flat and paged, ``cuda`` (on the CPU,
the kernels' plain versions; paged engines at page 128) — for boolean, ranked top-k, mixed-codec and
out-of-core (~10% resident budget) serving, and equals the oracle; the
torch and cuda engines also list-sharded at 1 and 2 CPU shards
(``test_dedup.py:113``).  The
queries are the JAX package's seeded random ASTs, rebuilt as the port's
nodes.

Interleaved ingestion with dedup and the memo on equals a rebuild from
scratch after every insert, on every engine (``test_dedup.py:256``).

Plus the behaviour pins: the probe memo flushes on ``swap_index``, the
prefetch thread is joined before its pages are used and never outlives a
drained workload, prefetch admission never grows the pool, a
duplicate-heavy workload shows ``dedup_factor > 1`` with a smaller
dispatch than the dedup-off path, a replayed workload hits the memo, a
4-entry memo churns and stays exact, and the LRU's counters.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

from strategies import adversarial_lists, random_ast

from repro.core.repair import repair_compress as repair_jax

from repro_torch.core.cache import LRUCache
from repro_torch.core.repair import (repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.engine import CudaEngine, HostEngine, TorchEngine
from repro_torch.query import And, QueryExecutor, Term, naive_eval, \
    rank_oracle
from repro_torch.query import ast as PA
from repro_torch.serve import QueryServer
from repro_torch.serve.scheduler import QueryScheduler
from repro_torch.store import ResidentSet, build_page_store

SEED = int(os.environ.get("REPRO_BENCH_SEED", "0"))
PAGE = 128
ENGINE_CONFIGS = ("host", "torch", "torch_paged", "cuda")


@pytest.fixture(scope="module")
def dlists():
    return adversarial_lists(np.random.default_rng(SEED + 99),
                             universe=700, n_random=8, max_len=70)


@pytest.fixture(scope="module")
def dres(dlists):
    return repair_result_from_arrays(
        *repair_result_to_arrays(repair_jax(dlists)))


def _make(name, res, **kw):
    dev = dict(max_short_len=64, device="cpu")
    if name == "host":
        return HostEngine(res, **kw)
    if name == "torch":
        return TorchEngine(res, **dev, **kw)
    if name == "torch_paged":
        return TorchEngine(res, paged=True, page_size=PAGE, **dev, **kw)
    if name == "cuda":
        return CudaEngine(res, page_size=PAGE, **dev, **kw)
    raise AssertionError(name)


def _off(eng):
    """Disable dedup and the memo: the serial dispatch path."""
    eng.dedup = False
    eng._probe_memo = LRUCache(0)
    return eng


def _on(eng):
    """Force dedup + memo ON whatever the environment's knobs say."""
    eng.dedup = True
    eng._probe_memo = LRUCache(4096)
    return eng


def _port_ast(node):
    """The JAX package's AST node rebuilt from the port's node classes
    (same names, same fields)."""
    kw = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if dataclasses.is_dataclass(v):
            v = _port_ast(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            v = tuple(_port_ast(c) for c in v)
        kw[f.name] = v
    return getattr(PA, type(node).__name__)(**kw)


def _workload(num_lists, n, seed_off=0):
    rng = np.random.default_rng(SEED + 31 + seed_off)
    return [_port_ast(random_ast(rng, num_lists)) for _ in range(n)]


def _budget(res):
    n = int(np.asarray(res.starts)[-1])
    return max(1, (-(-n // PAGE)) // 10)


# -- the differential gate: every knob combination ---------------------------

@pytest.mark.parametrize("ename", ENGINE_CONFIGS)
def test_dedup_memo_bit_identity(dlists, dres, ename):
    """dedup-on == memo-on == all-off == serial search == oracle, per
    lane, on every backend.  The workload repeats queries so dedup and
    the memo both engage."""
    queries = _workload(len(dlists), 16) * 2         # repeats across ticks
    base = _off(_make(ename, dres))
    serial = [QueryExecutor(base).search(q) for q in queries]
    combos = {"all-on": {}, "dedup-only": {"memo": 0},
              "memo-only": {"dedup": False},
              "all-off": {"memo": 0, "dedup": False}}
    for label, knobs in combos.items():
        eng = _on(_make(ename, dres))
        if knobs.get("dedup") is False:
            eng.dedup = False
        if knobs.get("memo") == 0:
            eng._probe_memo = LRUCache(0)
        sch = QueryScheduler(eng, batch_window=8, result_cache_size=0)
        for q, got, want in zip(queries, sch.search_many(queries), serial):
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{ename}/{label}")
            np.testing.assert_array_equal(
                got, naive_eval(q, dlists, dres.universe),
                err_msg=f"{ename}/{label}")


@pytest.mark.parametrize("ename", ("torch", "cuda"))
@pytest.mark.parametrize("shards", [1, 2])
def test_sharded_dispatch_bit_identity(dlists, dres, shards, ename):
    """The deduped and memoized rounds ride the sharded dispatch
    (``tests/test_dedup.py:113``), at 1 and 2 CPU shards."""
    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    queries = _workload(len(dlists), 10, seed_off=1) * 2
    eng = _on(_make(ename, dres, mesh=Mesh(["cpu"] * shards)))
    sch = QueryScheduler(eng, batch_window=8, result_cache_size=0)
    D.reset_dispatches()
    for algo in (None, "svs"):
        for q, got in zip(queries, sch.search_many(queries, algo)):
            np.testing.assert_array_equal(
                got, naive_eval(q, dlists, dres.universe))
    assert D.DISPATCHES["sharded_next_geq"] > 0
    assert sch.stats()["real_lanes"] >= sch.stats()["unique_lanes"]


@pytest.mark.parametrize("ename", ("host", "cuda"))
def test_topk_bit_identity(dlists, dres, ename):
    """Ranked top-k: deduped ScoreRounds + memoized membership probes
    return exactly the all-off docs AND scores."""
    rng = np.random.default_rng(SEED + 5)
    bags = [sorted(int(t) for t in rng.choice(8, 3, replace=False))
            for _ in range(10)] * 2
    sch_on = QueryScheduler(_on(_make(ename, dres)), batch_window=8,
                            result_cache_size=0)
    sch_off = QueryScheduler(_off(_make(ename, dres)), batch_window=8,
                             result_cache_size=0)
    got = sch_on.search_topk_many(bags, 10)
    want = sch_off.search_topk_many(bags, 10)
    for ts, a, b in zip(bags, got, want):
        np.testing.assert_array_equal(a.docs, b.docs)
        np.testing.assert_array_equal(a.scores, b.scores)
        od, osc = rank_oracle(dlists, dres.universe, ts, 10)
        np.testing.assert_array_equal(a.docs, od)
        np.testing.assert_array_equal(a.scores, osc)
    assert sch_on.stats()["unique_lanes"] < sch_on.stats()["real_lanes"]


@pytest.mark.parametrize("ename", ("host", "torch"))
def test_mixed_codec_bit_identity(dlists, dres, ename):
    """The dedup/memo layer sits ABOVE codec routing: adaptive-tier
    engines with the optimizations on match the oracle exactly."""
    queries = _workload(len(dlists), 12, seed_off=7) * 2
    eng = _on(_make(ename, dres, codec="adaptive"))
    sch = QueryScheduler(eng, batch_window=8, result_cache_size=0)
    for q, got in zip(queries, sch.search_many(queries, "svs")):
        np.testing.assert_array_equal(
            got, naive_eval(q, dlists, dres.universe), err_msg=ename)
    st = sch.stats()
    nonrep = {k: v for k, v in st["codec_dispatches"].items()
              if k != "repair"}
    assert sum(nonrep.values()) > 0     # the codec router really ran
    assert st["dedup_factor"] >= 1.0


# -- out-of-core: prefetch overlap ------------------------------------------

@pytest.mark.parametrize("ename", ("torch_paged", "cuda"))
def test_out_of_core_prefetch_bit_identity(dlists, dres, ename):
    """~10% resident budget, mmap store: prefetch-on == prefetch-off ==
    oracle, and the prefetch thread never outlives a drain."""
    queries = _workload(len(dlists), 16, seed_off=3) * 2
    for prefetch in (True, False):
        eng = _make(ename, dres, store="mmap",
                    resident_pages=_budget(dres))
        sch = QueryScheduler(eng, batch_window=8, result_cache_size=0,
                             prefetch=prefetch)
        for q, got in zip(queries, sch.search_many(queries)):
            np.testing.assert_array_equal(
                got, naive_eval(q, dlists, dres.universe),
                err_msg=f"prefetch={prefetch}")
        assert sch._pf_thread is None        # joined before drain returned
        st = sch.stats()
        assert st["page_faults"] > 0
        if prefetch:
            assert st["prefetch_enabled"]
        else:
            assert st["prefetched_pages"] == 0
            assert st["overlap_ms"] == 0.0


def test_prefetch_join_before_use(dres, dlists):
    """With an artificially SLOW store gather the main thread waits at
    the join point: prefetched pages enter the pool only after the join,
    on the main thread, and the answers stay exact."""
    eng = _make("cuda", dres, store="memory", resident_pages=_budget(dres))
    real_gather = eng.store.gather

    def slow_gather(pages):
        time.sleep(0.02)
        return real_gather(pages)

    eng.store.gather = slow_gather
    queries = _workload(len(dlists), 12, seed_off=9)
    sch = QueryScheduler(eng, batch_window=4, result_cache_size=0,
                         prefetch=True)
    for q, got in zip(queries, sch.search_many(queries)):
        np.testing.assert_array_equal(
            got, naive_eval(q, dlists, dres.universe))
    st = sch.stats()
    assert sch._pf_thread is None
    if st["prefetched_pages"]:
        assert st["prefetch_join_wait_ms"] > 0.0


def test_prefetch_admission_never_grows_pool(dres):
    """``admit_prefetched`` is best effort: it never grows the pool and
    skips pages that became resident since the snapshot."""
    store = build_page_store(dres, kind="memory", page_size=PAGE)
    rs = ResidentSet(store, budget=4)
    rs.ensure([0, 1])
    want = rs.peek_missing(np.arange(store.num_pages))
    assert 0 not in want and 1 not in want
    pages = want[:8]                    # more than the pool can absorb
    syms, sums = store.gather(pages)
    admitted = rs.admit_prefetched(pages, syms, sums)
    assert rs.pool_grows == 0
    assert admitted <= 4 and rs.resident_pages <= 4
    again = rs.admit_prefetched(pages[:admitted],
                                *store.gather(pages[:admitted]))
    assert again <= max(0, 4 - admitted) + 2   # only evictable slack
    before = rs.prefetch_useful
    rs.ensure(pages[:1])
    rs.ensure(pages[:1])
    assert rs.prefetch_useful == before + (1 if admitted else 0)


# -- swap pin -----------------------------------------------------------------

def test_memo_flush_on_swap(dlists, dres):
    """``swap_index`` leaves no stale memoized probe reachable: the swap
    builds a FRESH engine (fresh memo)."""
    srv = QueryServer(dres, engine="host")
    _on(srv.engine)
    q = And((Term(0), Term(1)))
    want_old = naive_eval(q, dlists, dres.universe)
    np.testing.assert_array_equal(srv.search(q, force_algo="svs"),
                                  want_old)
    old_engine = srv.engine
    assert len(old_engine._probe_memo) > 0      # probes were memoized
    new_lists = [np.unique(l // 2) for l in dlists]
    new_res = repair_result_from_arrays(
        *repair_result_to_arrays(repair_jax(new_lists)))
    srv.swap_index(new_res)
    assert srv.engine is not old_engine
    assert len(srv.engine._probe_memo) == 0     # structurally flushed
    want_new = naive_eval(q, new_lists, new_res.universe)
    np.testing.assert_array_equal(srv.search(q, force_algo="svs"),
                                  want_new)
    assert not np.array_equal(want_old, want_new)


@pytest.mark.parametrize("ename", ENGINE_CONFIGS)
def test_segmented_ingest_bit_identity(ename):
    """Interleaved insert/search with dedup and the memo on matches the
    rebuilt-from-scratch oracle after EVERY insert — the epoch pin: a
    memoized probe can never leak a pre-insert answer (delta answers are
    host-evaluated; segment engines are immutable)."""
    vocab = 40
    docs = [np.arange(vocab, dtype=np.int64)] + [
        np.unique(np.random.default_rng(SEED + 60 + i)
                  .integers(0, vocab, size=8))
        for i in range(14)]

    def invert(ds):
        inv = {}
        for d, terms in enumerate(ds):
            for t in terms.tolist():
                inv.setdefault(int(t), []).append(d)
        return [np.asarray(inv[t], np.int64) for t in sorted(inv)]

    kw = {"host": {}, "torch": dict(device="cpu"),
          "torch_paged": dict(device="cpu", paged=True, page_size=PAGE),
          "cuda": dict(device="cpu", page_size=PAGE)}[ename]
    res = repair_result_from_arrays(
        *repair_result_to_arrays(repair_jax(invert(docs[:8]))))
    srv = QueryServer(res, engine="torch" if ename == "torch_paged"
                      else ename, **kw)
    _on(srv.engine)
    srv.enable_ingest(delta_budget=2, compact_fanout=2)
    rng = np.random.default_rng(SEED + 2)
    for i, d in enumerate(docs[8:]):
        srv.insert(d)
        for seg in srv.segmented.segments:
            _on(seg.engine)
        cur = invert(docs[:9 + i])
        a, b = (int(t) for t in rng.choice(vocab, 2, replace=False))
        q = And((Term(a), Term(b)))
        # same query twice: the second submit exercises reuse paths
        for got in srv.search_many([q, q]):
            np.testing.assert_array_equal(
                got, naive_eval(q, cur, len(docs[:9 + i])))
    assert srv.serve_stats()["flushes"] >= 2


# -- dedup telemetry pins ----------------------------------------------------

def test_duplicate_heavy_dedup_factor_and_bucket(dlists, dres):
    """A duplicate-heavy workload shows dedup_factor > 1 AND a smaller
    dispatch: dispatched + pad lanes strictly below the dedup-off
    path's."""
    queries = [And((Term(0), Term(1), Term(2)))] * 24

    def run(on):
        eng = _make("cuda", dres)
        _on(eng) if on else _off(eng)
        sch = QueryScheduler(eng, batch_window=24, result_cache_size=0)
        outs = sch.search_many(queries, "svs")
        return sch.stats(), outs

    st_on, outs_on = run(True)
    st_off, outs_off = run(False)
    for a, b in zip(outs_on, outs_off):
        np.testing.assert_array_equal(a, b)
    assert st_on["dedup_factor"] > 1.0, st_on
    assert st_on["unique_lanes"] < st_on["real_lanes"]
    assert st_on["real_lanes"] == st_off["real_lanes"]
    assert (st_on["dispatched_lanes"] + st_on["pad_lanes"]
            < st_off["dispatched_lanes"] + st_off["pad_lanes"]), \
        (st_on, st_off)


def test_memo_hits_across_ticks(dlists, dres):
    """Replaying a workload on the SAME scheduler (result cache off)
    serves repeat probes from the memo — fewer dispatched lanes, a
    nonzero memo hit rate, the same answers."""
    queries = _workload(len(dlists), 10, seed_off=4)
    eng = _on(_make("host", dres))
    sch = QueryScheduler(eng, batch_window=8, result_cache_size=0)
    first = sch.search_many(queries, "svs")
    d1 = sch.stats()["dispatched_lanes"]
    second = sch.search_many(queries, "svs")
    d2 = sch.stats()["dispatched_lanes"] - d1
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    st = sch.stats()
    assert st["memo_hit_rate"] > 0.0, st
    assert d2 < d1, (d1, d2)
    assert st["probe_memo"]["hits"] > 0


def test_probe_memo_tiny_evicts(dlists, dres):
    """A 4-entry memo churns (evictions > 0) yet stays exact."""
    queries = _workload(len(dlists), 12, seed_off=6) * 2
    eng = _make("host", dres)
    eng._probe_memo = LRUCache(4)
    sch = QueryScheduler(eng, batch_window=8, result_cache_size=0)
    for q, got in zip(queries, sch.search_many(queries, "svs")):
        np.testing.assert_array_equal(
            got, naive_eval(q, dlists, dres.universe))
    assert eng._probe_memo.stats()["evictions"] > 0
    assert eng._probe_memo.stats()["size"] <= 4


def test_lru_counters():
    c = LRUCache(2)
    assert c.get("a") is None
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)                   # evicts b (a was just touched)
    assert c.get("b") is None
    st = c.stats()
    assert st["hits"] == 1 and st["misses"] == 2
    assert st["evictions"] == 1
    assert st["hit_rate"] == pytest.approx(1 / 3)
    c.flush()                       # counters survive a flush
    assert c.stats()["evictions"] == 1 and c.stats()["size"] == 0
