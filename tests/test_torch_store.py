"""The port's out-of-core tier against the JAX package's (``tests/test_store.py``).

The differential contract: a port engine serving from a bounded
admission cache over a page store (a resident budget of ~10% of the
stream's pages) is BIT-IDENTICAL to the same engine fully resident, to
the JAX package's counterpart under the same store and to the oracle —
for ``host``, ``torch`` (paged) and ``cuda`` (on the CPU: K1's resident
route runs its plain version), across boolean, ranked top-k and
mixed-codec workloads; and ``test_store.py``'s ``"sharded"`` engine (a
paged torch engine with a mesh of 1 and 2 CPU shards) out of core.

Plus the pins of ``tests/test_store.py``: the LRU discipline, the
bounded pool, the pool grown by an oversize tick, the fresh pool of
``swap_index`` and its version pin, the poison pin (``seq`` corrupted,
the in-memory stream dropped, answers still exact), the store units (the
``StoreResView`` decode, the paper's I/O bound, the mmap round trip,
``pages_in_spans``, ``resolve_store_kind``), the scheduler's cache
counters and the close-while-serving lifecycle.

And the resident route of K1 itself: its plain version over a pool whose
rows outside the working set are poisoned equals the JAX package's
``next_geq_resident`` (Pallas, interpret mode) and
``next_geq_batch_resident`` on the clean pool.
"""

import gc
import os

import numpy as np
import pytest
import torch

from strategies import adversarial_lists, make_lists

from repro.core import jax_index as JI
from repro.core.repair import repair_compress as repair_jax
from repro.engine import HostEngine as JHost, JnpEngine, PallasEngine
from repro.engine import jnp_backend as JB
from repro.kernels.list_intersect import ops as KJ
from repro.query import QueryExecutor as ExecJax
from repro.serve.scheduler import QueryScheduler as SchedJax
from repro.store import ResidentSet as JResidentSet
from repro.store import build_page_store as build_store_jax

from repro_torch.core import index as TI
from repro_torch.core.repair import (repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.engine import CudaEngine, HostEngine, TorchEngine
from repro_torch.engine import torch_backend as TB
from repro_torch.kernels.list_intersect import ops as K
from repro_torch.query import QueryExecutor, naive_eval, parse, rank_oracle
from repro_torch.serve import QueryServer
from repro_torch.serve.scheduler import QueryScheduler
from repro_torch.store import (MmapPageStore, ResidentSet, StoreResView,
                               build_page_store, pages_in_spans,
                               resolve_store_kind)

SEED = int(os.environ.get("REPRO_BENCH_SEED", "0"))
PAGE = 128
CONFIGS = ("host", "torch", "cuda")
CPU = torch.device("cpu")
INF = int(TI.INT_INF)


def _carry(rj):
    """The JAX package's RePairResult as the port's (same arrays)."""
    return repair_result_from_arrays(*repair_result_to_arrays(rj))


@pytest.fixture(scope="module")
def slists():
    # big enough that the stream cuts into dozens of 128-symbol pages —
    # a ~10% resident budget then leaves real eviction pressure
    return make_lists(np.random.default_rng(SEED + 17), n_lists=30,
                      universe=4000, min_len=5, max_len=600)


@pytest.fixture(scope="module")
def sres(slists):
    rj = repair_jax(slists)
    return rj, _carry(rj)


@pytest.fixture(scope="module")
def adv_lists():
    return adversarial_lists(np.random.default_rng(SEED + 99),
                             universe=700, n_random=8, max_len=70)


@pytest.fixture(scope="module")
def adv_res(adv_lists):
    rj = repair_jax(adv_lists)
    return rj, _carry(rj)


def _make(name, res, **kw):
    """A port engine of one configuration (device engines on the CPU)."""
    if name == "host":
        return HostEngine(res, method="lookup", page_size=PAGE, **kw)
    dev = dict(max_short_len=64, page_size=PAGE, device="cpu")
    if name == "torch":
        return TorchEngine(res, paged=True, **dev, **kw)
    return CudaEngine(res, **dev, **kw)


def _make_jax(name, res, **kw):
    """The JAX package's counterpart of :func:`_make`."""
    if name == "host":
        return JHost(res, method="lookup", page_size=PAGE, **kw)
    if name == "torch":
        return JnpEngine(res, max_short_len=64, paged=True, page_size=PAGE,
                         **kw)
    return PallasEngine(res, max_short_len=64, page_size=PAGE,
                        interpret=True, **kw)


def _budget(res):
    """~10% of the stream's pages, the out-of-core operating point of
    ``tests/test_store.py`` (at least 1)."""
    n = int(np.asarray(res.starts)[-1])
    return max(1, (-(-n // PAGE)) // 10)


def _bool_queries(rng, n_lists, n=16):
    qs = []
    for _ in range(n):
        ts = rng.choice(n_lists, size=int(rng.integers(2, 4)),
                        replace=False)
        qs.append(" AND ".join(str(int(t)) for t in ts))
    for _ in range(n // 3):
        a, b, c = (int(x) for x in rng.choice(n_lists, 3, replace=False))
        qs.append(f"({a} AND {b}) OR NOT {c}")
    return qs


# -- the differential gate ------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_outofcore_boolean_bit_identical(name, slists, sres):
    """Bounded-cache serving == the same engine fully resident == the JAX
    package's engine under the same store == oracle, for a coalesced
    boolean workload."""
    rj, rt = sres
    qs = _bool_queries(np.random.default_rng(SEED + 3), len(slists),
                       n=9 if name == "cuda" else 16)
    ref = QueryExecutor(_make(name, rt, store=""))
    want = [ref.search(q) for q in qs]
    eng = _make(name, rt, store="mmap", resident_pages=_budget(rt))
    assert eng.store.kind == "mmap" and eng.resident.budget == _budget(rt)
    got = QueryScheduler(eng, batch_window=8).search_many(qs)
    jeng = _make_jax(name, rj, store="mmap", resident_pages=_budget(rj))
    jgot = SchedJax(jeng, batch_window=8).search_many(qs)
    for q, w, g, j in zip(qs, want, got, jgot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(
            g, naive_eval(ref.plan(q).node, slists, rt.universe))
    st = eng.resident.stats()
    assert st["page_faults"] > 0 and st["hits"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_outofcore_topk_bit_identical(name, slists, sres):
    """Ranked top-k through the scheduler: block-max page decodes run
    against the resident pool, scores and order stay exact."""
    _, rt = sres
    rng = np.random.default_rng(SEED + 5)
    bags = [[int(x) for x in rng.choice(len(slists), size=3,
                                        replace=False)]
            for _ in range(8)]
    eng = _make(name, rt, store="mmap", resident_pages=_budget(rt))
    sch = QueryScheduler(eng, batch_window=8)
    for bag, r in zip(bags, sch.search_topk_many(bags, 5)):
        od, osc = rank_oracle(slists, rt.universe, bag, 5)
        np.testing.assert_array_equal(r.docs, od)
        np.testing.assert_array_equal(r.scores, osc)
    assert sch.stats()["page_faults"] > 0


@pytest.mark.parametrize("shards", [1, 2])
def test_outofcore_sharded_bit_identical(shards, slists, sres):
    """``tests/test_store.py``'s ``"sharded"`` engine: a paged torch engine
    with a mesh, out of core at ~10% residency.  The shards are cut from
    the full stream before the store drops it (sharding is its own
    residency: sharded probes fault nothing), the ranked decodes still
    read the pool; boolean and ranked answers equal the engine fully
    resident, the JAX package's meshed engine under the same store, and
    the oracle."""
    import jax
    from jax.sharding import Mesh as MeshJax

    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    rj, rt = sres
    mesh = Mesh(["cpu"] * shards)
    qs = _bool_queries(np.random.default_rng(SEED + 3), len(slists))
    ref = QueryExecutor(_make("torch", rt, store=""))
    want = [ref.search(q) for q in qs]
    eng = _make("torch", rt, store="mmap", resident_pages=_budget(rt),
                mesh=mesh)
    assert eng.fi.c.numel() == 1 and eng.resident is not None
    assert eng._sharded_next_geq is not None
    D.reset_dispatches()
    sch = QueryScheduler(eng, batch_window=8)
    got = sch.search_many(qs) + sch.search_many(qs[:8], "svs")
    assert D.DISPATCHES["sharded_next_geq"] > 0
    jeng = JnpEngine(rj, max_short_len=64, paged=True, page_size=PAGE,
                     store="mmap", resident_pages=_budget(rj),
                     mesh=MeshJax(np.array(jax.devices()[:1]), ("data",)))
    jgot = SchedJax(jeng, batch_window=8).search_many(qs)
    for q, w, g, j in zip(qs, want, got, jgot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(
            g, naive_eval(ref.plan(q).node, slists, rt.universe))
    for q, w, g in zip(qs, want, got[len(qs):]):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(SEED + 5)
    bags = [[int(x) for x in rng.choice(len(slists), size=3,
                                        replace=False)] for _ in range(6)]
    for bag, r in zip(bags, sch.search_topk_many(bags, 5)):
        od, osc = rank_oracle(slists, rt.universe, bag, 5)
        np.testing.assert_array_equal(r.docs, od)
        np.testing.assert_array_equal(r.scores, osc)
    assert eng.resident.stats()["page_faults"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_outofcore_mixed_codec(name, adv_lists, adv_res):
    """Adaptive codec tier out of core: EF and bitmap lanes never touch
    the stream pool, repair lanes fault through it — answers stay exact
    and equal the JAX package's."""
    rj, rt = adv_res
    qs = _bool_queries(np.random.default_rng(SEED + 7), len(adv_lists),
                       n=12)
    ref = QueryExecutor(_make(name, rt, store="", codec="adaptive"))
    want = [ref.search(q) for q in qs]
    eng = _make(name, rt, store="mmap", resident_pages=1, codec="adaptive")
    got = QueryScheduler(eng, batch_window=8).search_many(qs)
    jref = ExecJax(_make_jax("torch", rj, store="", codec="adaptive"))
    for q, w, g in zip(qs, want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jref.search(q))


def test_memory_store_matches_mmap(slists, sres):
    """The two store backends are interchangeable bit for bit."""
    _, rt = sres
    qs = _bool_queries(np.random.default_rng(SEED + 9), len(slists), n=12)
    outs = []
    for kind in ("memory", "mmap"):
        eng = _make("torch", rt, store=kind, resident_pages=_budget(rt))
        assert eng.store.kind == kind
        outs.append(QueryScheduler(eng, batch_window=8).search_many(qs))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# -- cache-discipline pins ------------------------------------------------


def test_lru_discipline_unit(sres):
    """ResidentSet is a true LRU under its budget: requests that fit
    never grow the pool, eviction removes the least recently ensured
    page, and the pages of the current request are pinned."""
    store = build_page_store(sres[1], kind="mmap", page_size=PAGE)
    assert store.num_pages >= 6
    rs = ResidentSet(store, budget=4)
    rs.ensure([0, 1, 2, 3])
    assert rs.resident_pages == 4 and rs.page_faults == 4
    rs.ensure([1])                       # refresh: 0 is now oldest
    rs.ensure([4])
    st = rs.slot_of_page
    assert st[0] == -1 and st[1] >= 0 and st[4] >= 0    # LRU victim was 0
    assert rs.page_evictions == 1 and rs.resident_pages == 4
    rs.ensure([0, 2, 3, 4])              # full-budget request: self-pinned
    assert rs.pool_grows == 0 and rs.resident_pages == 4
    assert all(st[p] >= 0 for p in (0, 2, 3, 4)) and st[1] == -1
    syms, _ = store.gather([2])
    got, _ = rs.read_span(2 * PAGE, 3 * PAGE)
    np.testing.assert_array_equal(got, syms[0])
    assert 0.0 < rs.hit_rate_window() <= 1.0


def test_device_mirror_follows_the_pool(sres):
    """``device_tables``: one full upload, then each fault batch lands by
    ``index_copy_`` into the same tensors; a ``_grow`` re-uploads the
    whole pool at its new shape.  The mirror always equals the numpy
    pool, and it never aliases it."""
    store = build_page_store(sres[1], kind="memory", page_size=PAGE)
    rs = ResidentSet(store, budget=3)
    rs.ensure([0, 1])
    syms, sums, slots = rs.device_tables(CPU)
    assert syms.shape == (3, PAGE)
    rs.ensure([5])
    syms2, sums2, slots2 = rs.device_tables(CPU)
    assert syms2 is syms and sums2 is sums        # incremental scatter
    assert slots2 is not slots                    # refreshed table
    rs.ensure(np.arange(6, 11))                   # 5 pages > budget 3
    assert rs.pool_grows == 1 and rs.budget == 6
    syms3, sums3, slots3 = rs.device_tables(CPU)
    assert syms3.shape == (6, PAGE) and syms3 is not syms
    for t, a in ((syms3, rs.pool_syms), (sums3, rs.pool_sums),
                 (slots3, rs.slot_of_page)):
        np.testing.assert_array_equal(t.numpy(), a)
        assert not np.shares_memory(t.numpy(), a)


@pytest.mark.parametrize("name", ("torch", "cuda"))
def test_device_mirror_orders_overlapping_batches(name, slists, sres):
    """Two pending fault batches that write the same pool row: a
    prefetch admission, then a demand ``ensure`` that evicts the
    prefetched pages into those rows, both before the next
    ``device_tables``.  The mirror applies them oldest first, so it
    equals the numpy pool and the probes stay exact."""
    _, rt = sres
    rng = np.random.default_rng(SEED + 41)
    lids = rng.choice(len(slists), 4, replace=False).repeat(8)
    lids = lids.astype(np.int32)
    xs = rng.integers(0, rt.universe, lids.size).astype(np.int32)
    probe = _make(name, rt, store="memory", resident_pages=1)
    n = K.probe_working_set(probe._route_host, lids, xs).size
    assert n >= 2
    eng = _make(name, rt, store="memory", resident_pages=n)
    rs = eng.resident
    ws = K.probe_working_set(eng._route_host, lids, xs)
    rest = np.setdiff1d(np.arange(rs.store.num_pages), ws)
    old, pf = rest[:n], rest[n:n + n // 2]
    rs.ensure(old)
    rs.device_tables(CPU)
    assert rs.admit_prefetched(pf, *rs.store.gather(pf)) == pf.size
    pf_rows = rs.slot_of_page[pf].copy()
    rs.ensure(ws)                       # evicts the rest of old, then pf
    assert (rs.slot_of_page[pf] < 0).all()
    assert np.isin(pf_rows, rs.slot_of_page[ws]).all()
    faults = rs.page_faults
    want = _make(name, rt, store="").next_geq_batch(lids, xs)
    np.testing.assert_array_equal(eng.next_geq_batch(lids, xs), want)
    assert rs.page_faults == faults and rs.pool_grows == 0
    for t, a in zip(rs.device_tables(CPU),
                    (rs.pool_syms, rs.pool_sums, rs.slot_of_page)):
        np.testing.assert_array_equal(t.numpy(), a)


def test_engine_pool_stays_bounded(slists, sres):
    """Serving a workload at a ~10% budget keeps the pool bounded:
    evictions happen, the resident set never exceeds the pool's (possibly
    grown) budget, and the pool never balloons to the whole stream."""
    _, rt = sres
    eng = _make("cuda", rt, store="mmap", resident_pages=max(2, _budget(rt)))
    sch = QueryScheduler(eng, batch_window=1)   # serial: small tick sets
    sch.search_many(_bool_queries(np.random.default_rng(SEED + 11),
                                  len(slists)))
    st = eng.resident.stats()
    assert st["resident_pages"] <= st["budget"] < st["num_pages"]
    assert st["page_evictions"] > 0
    assert 0.0 < st["hit_rate_window"] <= 1.0


@pytest.mark.parametrize("name", ("torch", "cuda"))
def test_tick_working_set_larger_than_budget_grows(name, slists, sres):
    """Correctness floor: a merged round needing more pages than the
    budget grows the pool instead of thrashing mid-dispatch."""
    _, rt = sres
    eng = _make(name, rt, store="mmap", resident_pages=1)
    rng = np.random.default_rng(SEED + 13)
    lids = rng.integers(0, len(slists), 256).astype(np.int32)
    xs = rng.integers(0, rt.universe, 256).astype(np.int32)
    base = _make(name, rt, store="")
    np.testing.assert_array_equal(base.next_geq_batch(lids, xs),
                                  eng.next_geq_batch(lids, xs))
    assert eng.resident.stats()["pool_grows"] > 0


def test_swap_index_fresh_pool_and_version_pin(slists, sres):
    """swap_index stands up a new engine with a NEW store + pool; a query
    in flight across the swap finishes on the index it was planned
    against."""
    _, rt = sres
    lists2 = make_lists(np.random.default_rng(SEED + 23), n_lists=30,
                        universe=4000, min_len=5, max_len=600)
    srv = QueryServer(rt, max_short_len=64, engine="cuda", device="cpu",
                      page_size=PAGE, store="mmap",
                      resident_pages=_budget(rt))
    q = "0 AND 1 AND 2"
    qid = srv.submit(q)
    srv.scheduler.tick()                 # in flight, pinned to v0
    old_engine, old_store = srv.engine, srv.engine.store
    res2 = _carry(repair_jax(lists2))
    srv.swap_index(res2)
    assert srv.engine is not old_engine
    assert srv.engine.store is not old_store
    assert srv.engine.resident is not old_engine.resident
    assert srv.engine.resident.budget == _budget(res2)
    srv.scheduler.drain()
    np.testing.assert_array_equal(
        srv.scheduler.take(qid),
        naive_eval(srv.plan(q).node, slists, rt.universe))
    np.testing.assert_array_equal(
        srv.search(q), naive_eval(srv.plan(q).node, lists2, res2.universe))


@pytest.mark.parametrize("name", CONFIGS)
def test_poison_pin_serving_reads_only_the_store(name, slists, sres):
    """After attach, corrupt every in-memory copy of the stream the
    engine could read instead of the store — the answers stay exact: the
    mmap store is the only source of stream symbols."""
    _, rt = sres
    eng = _make(name, rt, store="mmap", resident_pages=_budget(rt))
    seq_backup = rt.seq.copy()
    try:
        rt.seq[:] = -1
        if name != "host":
            assert eng.fi.c.numel() == 1                 # already dropped
            assert eng.pi.c_syms_pg.shape[0] == 1
            assert eng.pi.num_pages == eng.store.num_pages > 1
        qs = _bool_queries(np.random.default_rng(SEED + 29), len(slists),
                           n=10)
        got = QueryScheduler(eng, batch_window=8).search_many(qs)
        for q, g in zip(qs, got):
            np.testing.assert_array_equal(
                g, naive_eval(parse(q), slists, rt.universe))
    finally:
        rt.seq[:] = seq_backup


# -- store unit tests -------------------------------------------------------


def test_store_res_view_decodes(sres):
    """StoreResView (the host accessors' read view) decodes every list
    exactly like the in-memory RePairResult."""
    _, rt = sres
    store = build_page_store(rt, kind="mmap", page_size=PAGE)
    view = StoreResView(rt, ResidentSet(store, budget=2))
    for i in range(view.num_lists):
        np.testing.assert_array_equal(view.decode_list(i), rt.decode_list(i))
        np.testing.assert_array_equal(view.list_symbols(i),
                                      rt.list_symbols(i))


def test_io_optimality_bound(sres):
    """Paper §1/§6 at page granularity: retrieving list i touches at most
    1 + ceil((l~-1)/P) contiguous pages, l~ the COMPRESSED length."""
    store = build_page_store(sres[1], kind="mmap", page_size=PAGE)
    assert store.kind == "mmap" and store.disk_bytes > 0
    for i in range(store.meta["starts"].size - 1):
        lo, hi = store.list_span(i)
        bound = 1 + int(np.ceil(max(hi - lo - 1, 0) / PAGE))
        assert store.page_accesses(i) <= bound
        pages = store.span_pages(lo, hi)
        if pages.size:
            assert pages[-1] - pages[0] + 1 == pages.size


def test_mmap_store_round_trips(sres, tmp_path):
    """A store written under an explicit directory serves the same pages
    as the in-memory paging, as the device engine's pages and as the JAX
    package's store, in one batched gather."""
    rj, rt = sres
    mem = build_page_store(rt, kind="memory", page_size=PAGE)
    mm = build_page_store(rt, kind="mmap", page_size=PAGE,
                          store_dir=str(tmp_path))
    assert isinstance(mm, MmapPageStore)
    assert os.path.dirname(mm.path) == str(tmp_path)
    pi = TI.build_paged_index(TI.build_flat_index(rt, device=CPU), PAGE)
    jstore = build_store_jax(rj, kind="memory", page_size=PAGE)
    pages = np.arange(mm.num_pages)
    want = mem.gather(pages)
    for got in (mm.gather(pages), jstore.gather(pages),
                (pi.c_syms_pg.numpy(), pi.c_sums_pg.numpy())):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert mm.pages_gathered == mm.num_pages
    assert mm.meta["nt_orig"] == jstore.meta["nt_orig"]
    mm.close()
    # a paged index built with store= carries it and swaps in placeholders
    spi = TI.build_paged_index(pi.flat, PAGE, store="mmap",
                               store_dir=str(tmp_path))
    assert spi.store.kind == "mmap" and spi.c_syms_pg.shape == (1, PAGE)
    assert spi.num_pages == mem.num_pages
    mpi = TI.build_paged_index(pi.flat, PAGE, store="memory")
    assert mpi.store.kind == "memory" and torch.equal(mpi.c_syms_pg,
                                                      pi.c_syms_pg)


def test_pages_in_spans():
    assert pages_in_spans([0], [1], 128).tolist() == [0]
    assert pages_in_spans([0], [0], 128).tolist() == []        # empty span
    assert pages_in_spans([127], [129], 128).tolist() == [0, 1]
    assert pages_in_spans([0, 700], [5, 800], 128).tolist() == [0, 5, 6]
    assert pages_in_spans([256], [256 + 128], 128).tolist() == [2]
    assert pages_in_spans([380], [390], 384).tolist() == [0, 1]  # not pow2


def test_resolve_store_kind_env(monkeypatch):
    assert resolve_store_kind("mmap") == "mmap"
    assert resolve_store_kind("mem") == "memory"
    assert resolve_store_kind("none") is None
    assert resolve_store_kind("") is None
    monkeypatch.setenv("REPRO_STORE", "mmap")
    assert resolve_store_kind(None) == "mmap"
    monkeypatch.setenv("REPRO_STORE", "off")
    assert resolve_store_kind(None) is None
    monkeypatch.delenv("REPRO_STORE")
    assert resolve_store_kind(None) is None
    with pytest.raises(ValueError, match="unknown page store kind"):
        resolve_store_kind("tape")


def test_scheduler_stats_surface_cache_counters(slists, sres):
    _, rt = sres
    eng = _make("cuda", rt, store="mmap", resident_pages=_budget(rt))
    sch = QueryScheduler(eng, batch_window=4)
    sch.search_many(_bool_queries(np.random.default_rng(SEED + 31),
                                  len(slists), n=8))
    st = sch.stats()
    assert st["page_faults"] > 0
    assert st["fault_bytes"] == st["store"]["fault_bytes"] > 0
    assert st["resident_pages"] >= 1
    assert 0.0 <= st["store_hit_rate"] <= 1.0
    # fully resident engines report zeros (store="" opts out explicitly,
    # so a REPRO_STORE environment cannot re-enable it)
    st0 = QueryScheduler(_make("cuda", rt, store="")).stats()
    assert st0["page_faults"] == 0 and st0["store"] is None


# -- close-while-serving lifecycle -----------------------------------------


def test_close_while_pinned_defers_teardown(sres):
    """A close with readers pinned defers teardown until the last pin is
    released."""
    store = build_page_store(sres[1], kind="mmap", page_size=PAGE)
    path = store.path
    rs = ResidentSet(store, budget=2)
    assert store.pins == 1
    store.close()                      # reader still pinned: defer
    assert not store.closed and os.path.isdir(path)
    syms, _ = store.gather(np.asarray([0]))
    assert syms.shape == (1, PAGE)     # reads still served
    rs.ensure(np.asarray([0]))         # the pool can still fault
    rs.release()                       # last pin gone: deferred close fires
    assert store.closed and not os.path.isdir(path)
    with pytest.raises(RuntimeError):
        store.gather(np.asarray([0]))
    rs.release()                       # both idempotent
    store.close()


def test_close_unpinned_is_immediate(sres):
    store = build_page_store(sres[1], kind="mmap", page_size=PAGE)
    path = store.path
    store.close()
    assert store.closed and not os.path.isdir(path)


def test_pool_gc_releases_pin(sres):
    """Dropping the last reference to a ResidentSet releases its pin via
    the GC finalizer (exactly once with an explicit release())."""
    store = build_page_store(sres[1], kind="mmap", page_size=PAGE)
    rs = ResidentSet(store, budget=2)
    store.close()
    assert not store.closed
    del rs
    gc.collect()
    assert store.closed


def test_inflight_query_across_swap_and_close(slists, sres):
    """swap_index, then close() on the OLD index's mmap store while an
    out-of-core query is still in flight on it: the teardown defers, the
    query completes exactly, and the directory goes only when the old
    pool is released."""
    _, rt = sres
    lists2 = make_lists(np.random.default_rng(SEED + 31), n_lists=30,
                        universe=4000, min_len=5, max_len=600)
    srv = QueryServer(rt, max_short_len=64, engine="torch", paged=True,
                      device="cpu", page_size=PAGE, store="mmap",
                      resident_pages=_budget(rt))
    q = "0 AND 1 AND 2"
    qid = srv.submit(q)
    srv.scheduler.tick()                 # in flight, reading store v0
    old_engine, old_store = srv.engine, srv.engine.store
    path = old_store.path
    res2 = _carry(repair_jax(lists2))
    srv.swap_index(res2)
    old_store.close()                    # retire the old index's store
    assert not old_store.closed and os.path.isdir(path)
    srv.scheduler.drain()                # remaining rounds read the store
    np.testing.assert_array_equal(
        srv.scheduler.take(qid),
        naive_eval(srv.plan(q).node, slists, rt.universe))
    old_engine.resident.release()        # last reader gone
    assert old_store.closed and not os.path.isdir(path)
    np.testing.assert_array_equal(
        srv.search(q), naive_eval(srv.plan(q).node, lists2, res2.universe))


# -- K1's resident route ----------------------------------------------------


def _lanes(lists, universe, pick, settled, n=160, seed=3):
    """Random lanes on the lists ``pick`` plus each one's edge lanes, and
    on the lists ``settled`` only lanes that need no stream read (at or
    before the head, past the tail) — their pages stay outside the
    working set."""
    rng = np.random.default_rng(seed)
    lids = list(rng.choice(pick, n))
    xs = list(rng.integers(0, universe + 50, n))
    for t in pick:
        arr = lists[t]
        for x in (0, arr[0], arr[0] + 1, arr[len(arr) // 2], arr[-1],
                  arr[-1] + 1, universe + 5):
            lids.append(t)
            xs.append(int(x))
    for t in settled:
        arr = lists[t]
        for x in (0, arr[0], arr[-1] + 1):
            lids.append(t)
            xs.append(int(x))
    return np.asarray(lids, np.int32), np.asarray(xs, np.int32)


@pytest.mark.parametrize("page", [128, 384])
def test_next_geq_resident_poisoned_pool(page, slists, sres):
    """K1's resident route (plain version) over a pool smaller than the
    stream whose rows outside the working set — row 0, which absent pages
    clamp to, among them — hold random int32 values: every lane equals
    the JAX package's ``next_geq_resident`` (Pallas, interpret) and
    ``next_geq_batch_resident`` on the clean pool, the port's torch
    program on the poisoned pool, the fully resident route and the
    oracle.  Lanes whose start state answers or whose x lies beyond the
    list — some on lists outside the working set, whose pages read as
    poison — read nothing their answer depends on."""
    rj, rt = sres
    pi = TI.build_paged_index(TI.build_flat_index(rt, device=CPU), page)
    tables, statics, host = K.pad_paged_operands(pi, include_stream=False)
    full = K.pad_paged_operands(pi)[0]
    starts = np.asarray(rt.starts)
    mid = pi.num_pages // 2
    pick = np.flatnonzero(starts[1:] <= mid * page)
    settled = np.flatnonzero(starts[:-1] >= (mid + 1) * page)
    lids, xs = _lanes(slists, rt.universe, pick, settled)
    ws = K.probe_working_set(host, lids, xs)
    assert not np.isin(starts[settled] // page, ws).any()
    others = np.setdiff1d(np.arange(pi.num_pages), ws)[:3]
    budget = ws.size + others.size
    assert 0 < ws.size and budget < pi.num_pages

    store = build_page_store(rt, kind="memory", pi=pi)
    rs = ResidentSet(store, budget=budget)
    jstore = build_store_jax(rj, kind="memory", page_size=page)
    jrs = JResidentSet(jstore, budget=budget)
    for r in (rs, jrs):
        r.ensure(others)               # row 0 holds a page outside ws
        r.ensure(ws)
    assert rs.slot_of_page[others[0]] == 0 and rs.pool_grows == 0
    syms, sums, slots = rs.device_tables(CPU)
    assert K.poison_outside(syms, sums, slots, ws, seed=page) \
        == others.size

    got = K.next_geq_resident(tables, host, rs, lids, xs, **statics)
    assert rs.page_faults == budget                # nothing re-faulted
    prog = TB.next_geq_batch_resident(pi, syms, sums, slots,
                                      torch.from_numpy(lids),
                                      torch.from_numpy(xs)).numpy()
    pij = JI.build_paged_index(JI.build_flat_index(rj), page)
    tj, sj, hj = KJ.pad_paged_operands(pij, include_stream=False)
    pallas = KJ.next_geq_resident(tj, hj, jrs, lids, xs, interpret=True,
                                  **sj)
    jnp_res = np.asarray(JB.next_geq_batch_resident(
        pij, *jrs.device_tables(), lids, xs))
    oracle = []
    for t, x in zip(lids.tolist(), xs.tolist()):
        p = int(np.searchsorted(slists[t], x))
        oracle.append(int(slists[t][p]) if p < len(slists[t]) else INF)
    for want in (pallas, jnp_res, prog,
                 K.next_geq_paged(full, host, lids, xs, **statics),
                 np.asarray(oracle)):
        np.testing.assert_array_equal(got, want)


def test_resident_programs_match_repro(slists, sres):
    """The torch resident programs — list expansion and the ranked
    page-entry decode — over a pool whose rows outside the windows'
    pages are poisoned equal the JAX package's ``expand_batch_resident``
    and ``decode_pages_resident`` on the clean pool, and the fully
    resident programs."""
    rj, rt = sres
    pi = TI.build_paged_index(TI.build_flat_index(rt, device=CPU), PAGE)
    pij = JI.build_paged_index(JI.build_flat_index(rj), PAGE)
    starts = np.asarray(rt.starts, np.int64)
    ids = np.arange(0, len(slists), 3)
    max_len = 256
    si = JI.build_score_index(rj, page_size=PAGE)
    ent = np.arange(0, si.pg_page.size, 7)
    lo = np.concatenate([starts[ids], si.pg_sym_lo[ent]])
    hi = np.concatenate([np.minimum(starts[ids + 1], starts[ids] + max_len),
                         si.pg_sym_hi[ent]])
    ws = pages_in_spans(lo, hi, PAGE)
    rs = ResidentSet(build_page_store(rt, kind="memory", pi=pi),
                     budget=ws.size + 2)
    jrs = JResidentSet(build_store_jax(rj, kind="memory", page_size=PAGE),
                       budget=ws.size + 2)
    others = np.setdiff1d(np.arange(pi.num_pages), ws)[:2]
    for r in (rs, jrs):
        r.ensure(others)
        r.ensure(ws)
    pool = rs.device_tables(CPU)
    assert K.poison_outside(*pool, ws, seed=7) == 2
    ids_t = torch.from_numpy(ids.astype(np.int32))
    got = TB.expand_batch_resident(pi, *pool, ids_t, max_len).numpy()
    want = np.asarray(JB.expand_batch_resident(
        pij, *jrs.device_tables(), ids.astype(np.int32), max_len))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TB.expand_batch(pi.flat, ids_t, max_len).numpy())
    cols = [torch.from_numpy(np.asarray(c[ent], np.int32)) for c in
            (si.pg_sym_lo, si.pg_sym_hi, si.pg_base, si.pg_head)]
    kw = dict(win=PAGE, max_elems=128)
    got = TB.decode_pages_resident(pi, *pool, *cols, **kw).numpy()
    want = np.asarray(JB.decode_pages_resident(
        pij, *jrs.device_tables(), *(c.numpy() for c in cols), **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TB.decode_pages_batch(pi.flat, *cols, **kw).numpy())


def test_engines_adopt_a_prebuilt_store(slists, sres):
    """A prebuilt PageStore passes through ``store=``: a device engine and
    a host engine over the same store each keep a pool of their own and
    each pin the store; answers stay exact."""
    _, rt = sres
    store = build_page_store(rt, kind="mmap", page_size=PAGE)
    dev = _make("cuda", rt, store=store, resident_pages=_budget(rt))
    host = HostEngine(rt, store=store, resident_pages=_budget(rt))
    assert dev.store is store and host.store is store
    assert host.resident is not dev.resident
    rng = np.random.default_rng(SEED + 37)
    lids = rng.integers(0, len(slists), 64).astype(np.int32)
    xs = rng.integers(0, rt.universe, 64).astype(np.int32)
    want = _make("cuda", rt, store="").next_geq_batch(lids, xs)
    np.testing.assert_array_equal(dev.next_geq_batch(lids, xs), want)
    faults = dev.resident.page_faults
    np.testing.assert_array_equal(host.next_geq_batch(lids, xs), want)
    assert dev.resident.page_faults == faults and host.resident.lookups > 0
    for i in range(len(slists)):
        np.testing.assert_array_equal(host.decode_list(i), slists[i])
    dev.resident.release()
    store.close()
    assert not store.closed          # the host engine's pool still pins it
    host.resident.release()
    assert store.closed
