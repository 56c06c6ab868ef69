"""The port's codec tier (Re-Pair / Elias-Fano / bitmap) against the JAX
package's.

Inputs are made from seeds with numpy and go through both packages; doc
ids and ``next_geq`` values must be exactly equal, BM25 scores bit for
bit:

* **stores** — ``build_ef_store`` / ``build_bitmap_store`` arrays, the
  select samples, ``choose_codecs`` / ``build_codec_tier`` and
  ``space_report`` in every mode;
* **EF probes** — ``ef_next_geq_torch``, kernel K3's wrapper on CPU
  tensors (its plain version) and ``next_geq_ef`` against the JAX
  package's numpy, jnp and Pallas (interpret mode) paths, on stores with
  absent lists, ``l == 0`` lists and fields that straddle words, probed at
  members, their neighbours, bucket boundaries, heads, tails, past the
  tail and at negative ``x``;
* **bitmap probes** — ``bitmap_next_geq_torch`` against numpy and jnp;
* **engines** — ``host`` / ``torch`` / ``cuda`` (plain versions on the
  CPU) against ``HostEngine`` / ``JnpEngine`` / ``PallasEngine(interpret
  =True)`` under ``ef``, ``bitmap`` and ``adaptive``: probes,
  intersections, and merged rounds with their lane ledger and
  ``codec_dispatches``;
* **server** — ``QueryServer(codec=...)`` boolean and ranked workloads;
* **sharded** — each tiered mode on a ``TorchEngine`` with a mesh of 1
  and 2 CPU shards, beside ``JnpEngine`` on a 1-device mesh;
* **selection and caching** — ``REPRO_CODEC``, the bounded version-keyed
  EF pack cache and its flush on ``swap_index``;
* **carry-over** — a tier rebuilt from the JAX package's arrays serves
  like the JAX package.
"""

import numpy as np
import pytest
import torch

from strategies import adversarial_lists

from benchmarks.common import boolean_workload as boolean_jax
from benchmarks.common import ranked_workload as ranked_jax
from repro.core import ef as EFJ
from repro.core.repair import repair_compress as repair_jax
from repro.engine import HostEngine as JHost, JnpEngine, PallasEngine
from repro.index import codec_tier as CTJ
from repro.kernels.ef_next_geq import ops as EFKJ
from repro.query import ListStats as ListStatsJax
from repro.serve.query_serve import QueryServer as ServerJax

from repro_torch.core import ef as EF
from repro_torch.core.index import INT_INF
from repro_torch.core.repair import (repair_compress,
                                     repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.engine import CudaEngine, HostEngine, TorchEngine
from repro_torch.index import codec_tier as CT
from repro_torch.index.corpus import zipf_corpus
from repro_torch.kernels.ef_next_geq import ops as EFK
from repro_torch.launch import serve as launch
from repro_torch.query import ListStats, naive_eval, rank_oracle
from repro_torch.serve import QueryServer

SEED = 5
MAX_SHORT = 64
TIERED = ("ef", "bitmap", "adaptive")


# -- stores ------------------------------------------------------------------

def _stores():
    """(name, lists, universe) of the EF stores under test."""
    rng = np.random.default_rng(SEED)
    adv = adversarial_lists(rng, universe=900, n_random=10, max_len=80)
    # every other list absent: the directory has gaps
    gaps = [v if i % 2 == 0 else None for i, v in enumerate(adv)]
    # l == 0 (dense) and l == 1 lists, next to an empty one
    dense = [np.arange(0, 500), np.arange(0, 300, 2), None,
             np.asarray([0, 1, 2, 3, 5, 6, 7]), np.arange(100, 164)]
    # sparse lists over a wide universe: l up to 30, fields straddle words
    u = 2**31 - 1
    wide = [np.unique(rng.integers(0, u, int(rng.integers(2, 40))))
            for _ in range(6)] + [np.asarray([2**30 + 5]),
                                  np.asarray([u - 1]),
                                  np.asarray([7, 2**29, 2**30 + 3])]
    return [("gaps", gaps, 900), ("dense", dense, 500), ("wide", wide, u)]


STORES = _stores()


@pytest.fixture(scope="module", params=STORES, ids=[s[0] for s in STORES])
def stores(request):
    """(lists, universe, port store, JAX-package store)."""
    _, lists, u = request.param
    return lists, u, EF.build_ef_store(lists, u), EFJ.build_ef_store(lists, u)


def _probes(lists, universe):
    """(lids, xs): members, their neighbours, every bucket boundary of each
    list (``h << l`` and ``((h + 1) << l) - 1``), 0, the middle, the last
    slot, past the universe, negative probes and INT_MAX — on every list
    id, absent ones included."""
    ls, xs = [], []
    for i, v in enumerate(lists):
        v = np.zeros(0, np.int64) if v is None else np.asarray(v, np.int64)
        p = [v, v - 1, v + 1,
             [0, universe // 2, universe - 1, universe + 5, -1, -7,
              -2**31, 2**31 - 1]]
        if v.size:
            l = EF._list_lbits(v.size, int(v[-1]))
            h = np.unique(v >> l)
            p += [h << l, ((h + 1) << l) - 1]
        p = np.unique(np.clip(np.concatenate(p), -2**31, 2**31 - 1))
        ls.append(np.full(p.size, i))
        xs.append(p)
    return (np.concatenate(ls).astype(np.int32),
            np.concatenate(xs).astype(np.int32))


def _oracle(lists, lids, xs):
    out = np.full(lids.size, int(INT_INF), np.int64)
    for q, (li, x) in enumerate(zip(lids.tolist(), xs.tolist())):
        v = lists[li]
        if v is None or len(v) == 0:
            continue
        j = int(np.searchsorted(v, x))
        if j < len(v):
            out[q] = v[j]
    return out.astype(np.int32)


def test_ef_store_equals_repro(stores):
    lists, _, st, sj = stores
    for f in ("n", "lbits", "firsts", "lasts", "lo_word", "hi_word",
              "lo_words", "hi_words"):
        a, b = getattr(st, f), getattr(sj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (st.universe, st.max_bucket) == (sj.universe, sj.max_bucket)
    np.testing.assert_array_equal(st.select_samples(), sj.select_samples())
    assert st.size_bits() == sj.size_bits()
    for i, v in enumerate(lists):
        np.testing.assert_array_equal(
            st.decode(i), np.zeros(0, np.int64) if v is None else v)


def test_ef_probes_equal_repro(stores):
    """The torch twin, K3's wrapper (plain version on CPU tensors) and the
    numpy-in/numpy-out path equal the JAX package's numpy and jnp paths
    and the oracle on every probe; the Pallas kernel (interpret mode) on
    a few hundred of them."""
    lists, u, st, sj = stores
    lids, xs = _probes(lists, u)
    rank = st.select_samples()
    want = EFJ.ef_next_geq_np(sj, rank, lids, xs)
    np.testing.assert_array_equal(want, _oracle(lists, lids, xs))
    np.testing.assert_array_equal(
        np.asarray(EFJ.ef_next_geq_jnp(EFJ.ef_device_pack(sj, rank), lids,
                                       xs)), want)
    np.testing.assert_array_equal(EF.ef_next_geq_np(st, rank, lids, xs),
                                  want)
    pack = EFK.pad_ef_operands(st, rank, "cpu")
    assert pack["hi_words"].numel() >= 1
    lt, xt = torch.from_numpy(lids), torch.from_numpy(xs)
    got = EF.ef_next_geq_torch(pack, lt, xt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(EFK.ef_next_geq(lt, xt, pack).numpy(),
                                  want)
    np.testing.assert_array_equal(EFK.next_geq_ef(pack, lids, xs), want)
    pick = np.random.default_rng(SEED).choice(
        lids.size, min(256, lids.size), replace=False)
    tables, statics = EFKJ.pad_ef_operands(sj)
    np.testing.assert_array_equal(
        EFKJ.next_geq_ef(tables, statics, sj, rank, lids[pick], xs[pick],
                         interpret=True), want[pick])


def test_ef_pack_and_wrapper_contract():
    """An empty high-bits array packs as one zero word; the wrapper refuses
    lanes of another shape and devices other than the CPU or a card; the
    numpy path refuses list ids outside the directory."""
    st = EF.build_ef_store([None, None], 10)
    pack = EFK.pad_ef_operands(st, st.select_samples(), "cpu")
    assert pack["hi_words"].tolist() == [0]
    assert set(pack) == set(EF.EF_PACK)
    assert all(t.dtype == torch.int32 and t.is_contiguous()
               for t in pack.values())
    assert EFK.next_geq_ef(pack, [0, 1], [3, -1]).tolist() == \
        [int(INT_INF)] * 2
    with pytest.raises(IndexError, match="list id"):
        EFK.next_geq_ef(pack, [2], [0])
    with pytest.raises(ValueError, match="one \\(Q,\\) shape"):
        EFK.ef_next_geq(torch.zeros(3, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), pack)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        EFK.ef_next_geq(torch.zeros(4, dtype=torch.int32, device=meta),
                        torch.zeros(4, dtype=torch.int32, device=meta),
                        {k: v.to(meta) for k, v in pack.items()})


def test_bitmap_store_and_probes_equal_repro():
    _, lists, u = STORES[0]
    lists = [v for v in lists if v is not None] + [None]
    bs, bj = CT.build_bitmap_store(lists, u), CTJ.build_bitmap_store(lists, u)
    for f in ("words", "word_start", "nxt", "counts", "firsts", "lasts"):
        np.testing.assert_array_equal(getattr(bs, f), getattr(bj, f),
                                      err_msg=f)
    assert bs.size_bits() == bj.size_bits()
    lids, xs = _probes(lists, u)
    want = CTJ.bitmap_next_geq_np(bj, lids, xs)
    np.testing.assert_array_equal(want, _oracle(lists, lids, xs))
    np.testing.assert_array_equal(
        np.asarray(CTJ.bitmap_next_geq_jnp(CTJ.bitmap_device_pack(bj), lids,
                                           xs)), want)
    np.testing.assert_array_equal(CT.bitmap_next_geq_np(bs, lids, xs), want)
    got = CT.bitmap_next_geq_torch(CT.bitmap_device_pack(bs, "cpu"),
                                   torch.from_numpy(lids),
                                   torch.from_numpy(xs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(CT.bitmap_member_np(bs, lids, xs),
                                  CTJ.bitmap_member_np(bj, lids, xs))


# -- the corpus the engines and servers serve --------------------------------

@pytest.fixture(scope="module")
def corpus():
    """Zipf postings (adaptive picks all three codecs on them), the JAX
    package's Re-Pair result, and the same result carried into the port."""
    lists = zipf_corpus(num_docs=400, vocab_size=500, mean_doc_len=30,
                        seed=SEED).postings()
    rj = repair_jax(lists)
    arrays, statics = repair_result_to_arrays(rj)
    return lists, rj, repair_result_from_arrays(arrays, statics)


@pytest.mark.parametrize("mode", ["repair", "ef", "bitmap", "adaptive"])
def test_codec_tiers_equal_repro(corpus, mode, monkeypatch):
    monkeypatch.delenv("REPRO_CODEC", raising=False)
    lists, rj, rt = corpus
    tier, tj = CT.build_codec_tier(rt, mode), CTJ.build_codec_tier(rj, mode)
    if mode == "repair":
        assert tier is None and tj is None
        return
    np.testing.assert_array_equal(tier.codec, tj.codec)
    assert tier.space_report(rt) == tj.space_report(rj)
    lasts = np.asarray([v[-1] if len(v) else -1 for v in lists])
    np.testing.assert_array_equal(CT.estimate_codec_bits(rt, lasts),
                                  CTJ.estimate_codec_bits(rj, lasts))
    np.testing.assert_array_equal(CT.choose_codecs(rt, lasts, mode),
                                  CTJ.choose_codecs(rj, lasts, mode))
    if mode == "adaptive":
        assert min(tier.counts().values()) > 0     # all three codecs used


# -- engines -----------------------------------------------------------------

def _pair(name, codec, rj, rt):
    """(port engine, JAX-package engine) of one configuration."""
    if name == "host":
        return HostEngine(rt, codec=codec), JHost(rj, codec=codec)
    if name == "torch":
        return (TorchEngine(rt, max_short_len=MAX_SHORT, device="cpu",
                            codec=codec),
                JnpEngine(rj, max_short_len=MAX_SHORT, codec=codec))
    return (CudaEngine(rt, max_short_len=MAX_SHORT, device="cpu",
                       codec=codec),
            PallasEngine(rj, max_short_len=MAX_SHORT, interpret=True,
                         codec=codec))


PAIRS = [(e, c) for c in TIERED for e in ("host", "torch", "cuda")]


@pytest.fixture(scope="module", params=PAIRS,
                ids=[f"{e}-{c}" for e, c in PAIRS])
def engines(request, corpus):
    name, codec = request.param
    _, rj, rt = corpus
    return request.param, *_pair(name, codec, rj, rt)


def _lanes(lists, universe, n=150, seed=SEED):
    """Random lanes plus the head, tail and past-the-tail of the longest
    lists and of some of every codec's lists."""
    rng = np.random.default_rng(seed)
    lids = list(rng.integers(0, len(lists), n))
    xs = list(rng.integers(-2, universe + 5, n))
    order = np.argsort([-len(v) for v in lists])
    for t in list(order[:12]) + list(order[40:400:40]):
        v = lists[int(t)]
        for x in (0, v[0], v[len(v) // 2], v[-1], v[-1] + 1):
            lids.append(int(t))
            xs.append(int(x))
    return np.asarray(lids, np.int32), np.asarray(xs, np.int32)


def test_engine_probes_equal_repro(engines, corpus):
    (name, codec), port, ref = engines
    lists, rj, _ = corpus
    assert np.array_equal(port.tier.codec, ref.tier.codec)
    lids, xs = _lanes(lists, rj.universe)
    got = port.next_geq_batch(lids, xs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.next_geq_batch(lids, xs))
    np.testing.assert_array_equal(got, _oracle(lists, lids, xs))
    np.testing.assert_array_equal(port.member_batch(lids, xs),
                                  ref.member_batch(lids, xs))
    np.testing.assert_array_equal(port.next_geq_bys_batch(lids, xs),
                                  ref.next_geq_bys_batch(lids, xs))


def test_engine_intersections_equal_repro(engines, corpus):
    (name, codec), port, ref = engines
    lists, _, _ = corpus
    order = [int(t) for t in np.argsort([-len(v) for v in lists])]
    rng = np.random.default_rng(SEED + 1)
    pairs = [tuple(map(int, rng.choice(order[:60], 2, replace=False)))
             for _ in range(8)] + [(order[0], order[1]), (order[2], 7)]
    for (a, b), g, w in zip(pairs, port.intersect_pairs(pairs),
                            ref.intersect_pairs(pairs)):
        np.testing.assert_array_equal(g, w, err_msg=f"{a},{b}")
        np.testing.assert_array_equal(g, np.intersect1d(lists[a], lists[b]))
    for q in ([order[5], order[9], order[30]], [order[0], order[3]], [4]):
        np.testing.assert_array_equal(port.intersect_multi(q),
                                      ref.intersect_multi(q))
    # meld: one probe round per alternation, so a short list bounds it
    q = [order[2], order[150], order[8]]
    np.testing.assert_array_equal(port.intersect_multi_meld(q),
                                  ref.intersect_multi_meld(q))


@pytest.mark.parametrize("algo", ["svs", "bys"])
def test_dispatch_round_equal_repro(engines, corpus, algo):
    """Merged rounds with duplicate lanes, split by codec: the same values,
    lane ledger (pad lanes per codec sub-round included) and per-codec
    dispatch counts as the JAX package, on a first round and on its
    memo-served repeat."""
    (name, codec), port, ref = engines
    lists, rj, _ = corpus
    lids, xs = _lanes(lists, rj.universe, n=41, seed=SEED + len(algo))
    lids = np.concatenate([lids, lids[:23]])
    xs = np.concatenate([xs, xs[:23]])

    def run(eng):
        st0, cd0 = dict(eng.lane_stats), dict(eng.codec_dispatches)
        out = eng.dispatch_round(lids, xs, algo)
        return (out, {k: eng.lane_stats[k] - st0[k] for k in st0},
                {k: eng.codec_dispatches[k] - cd0[k] for k in cd0})

    for _ in range(2):
        got, ledger, disp = run(port)
        want, ledger_j, disp_j = run(ref)
        np.testing.assert_array_equal(got, want)
        assert ledger == ledger_j
        assert disp == disp_j
    assert sum(port.codec_dispatches.values()) > 0


def test_cuda_engine_routes_ef_lanes_through_k3(corpus, monkeypatch):
    """Under a tier every EF lane of a CudaEngine reaches K3's wrapper —
    pair and k-term probes included — and no EF lane reaches K1's."""
    import repro_torch.kernels.ef_next_geq.ops as K3
    import repro_torch.kernels.list_intersect.ops as K1
    lists, _, rt = corpus
    eng = CudaEngine(rt, max_short_len=MAX_SHORT, device="cpu", codec="ef")
    seen = {"ef": [], "repair": []}
    for mod, fn, key in ((K3, "ef_next_geq", "ef"),
                         (K1, "paged_intersect", "repair")):
        wrapped = getattr(mod, fn)

        def counting(*a, _w=wrapped, _k=key, **kw):
            seen[_k].append(a[0].clone())
            return _w(*a, **kw)
        monkeypatch.setattr(mod, fn, counting)
    order = [int(t) for t in np.argsort([-len(v) for v in lists])]
    eng.intersect_pairs([(order[0], order[1]), (order[3], 11)])
    eng.intersect_multi([order[2], order[4], order[6]])
    eng.dispatch_round(np.asarray(order[:5], np.int32),
                       np.full(5, 17, np.int32), "svs")
    assert len(seen["ef"]) == 4 and not seen["repair"]
    ef_lists = set(np.flatnonzero(eng.tier.codec == CT.CODEC_EF).tolist())
    assert set(torch.cat(seen["ef"]).tolist()) <= ef_lists


# -- server ------------------------------------------------------------------

def _workloads(lists, n_bool, n_ranked):
    lengths = [len(l) for l in lists]
    qj = boolean_jax(len(lists), lengths, n_queries=n_bool, seed=SEED)
    qt = launch.boolean_workload(len(lists), lengths, n_queries=n_bool,
                                 seed=SEED)
    bags = launch.ranked_workload(len(lists), lengths, n_queries=n_ranked,
                                  seed=SEED)
    assert bags == ranked_jax(len(lists), lengths, n_queries=n_ranked,
                              seed=SEED)
    return qj, qt, bags


def _serve_and_compare(srv, ref, lists, universe):
    qj, qt, bags = _workloads(lists, 40, 10)
    for q, g, w in zip(qt, srv.search_many(qt), ref.search_many(qj)):
        np.testing.assert_array_equal(g, w, err_msg=repr(q))
        np.testing.assert_array_equal(g, naive_eval(q, lists, universe))
    for bag, g, w in zip(bags, srv.search_topk_many(bags, 10),
                         ref.search_topk_many(bags, 10)):
        np.testing.assert_array_equal(g.docs, w.docs, err_msg=str(bag))
        np.testing.assert_array_equal(g.scores.view(np.uint32),
                                      w.scores.view(np.uint32))
        od, osc = rank_oracle(lists, universe, bag, 10)
        np.testing.assert_array_equal(g.docs, od)
        np.testing.assert_array_equal(g.scores, osc)
    st, sj = srv.serve_stats(), ref.serve_stats()
    for key in ("completed", "real_lanes", "unique_lanes", "pad_lanes",
                "codec_dispatches"):
        assert st[key] == sj[key], key
    return st


@pytest.mark.parametrize("codec", TIERED)
def test_server_workloads_equal_repro(corpus, codec):
    """``QueryServer(codec=...)`` on the port's cuda engine (plain
    versions) and the JAX package's server: boolean answers, ranked docs
    and float32 scores, lane ledger and per-codec dispatches all equal;
    the planner sees the same codec column and prints the same plans."""
    lists, rj, rt = corpus
    srv = QueryServer(rt, engine="cuda", device="cpu", batch_window=8,
                      codec=codec)
    ref = ServerJax(rj, engine="jnp", batch_window=8, codec=codec)
    st = _serve_and_compare(srv, ref, lists, rj.universe)
    assert st["codec_dispatches"][codec if codec != "adaptive" else "ef"] > 0
    np.testing.assert_array_equal(ListStats.from_engine(srv.engine).codecs,
                                  ListStatsJax.from_engine(ref.engine).codecs)
    q = "(0 AND 1) OR NOT 2"
    assert srv.explain(q) == ref.explain(q)


def test_tier_carried_from_repro_serves_like_repro(corpus, monkeypatch):
    """A tier rebuilt from the JAX package's tier arrays equals the port's
    own build, passes through the engines unchanged, and serves exactly
    like the JAX package."""
    monkeypatch.delenv("REPRO_CODEC", raising=False)
    lists, rj, rt = corpus
    tj = CTJ.build_codec_tier(rj, "adaptive")
    arrays, statics = CT.codec_tier_to_arrays(tj)
    tier = CT.codec_tier_from_arrays(arrays, statics)
    own = CT.build_codec_tier(rt, "adaptive")
    a2, s2 = CT.codec_tier_to_arrays(own)
    assert s2 == statics and a2.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(a2[k], arrays[k], err_msg=k)
        assert a2[k].dtype == arrays[k].dtype, k
    assert isinstance(tier.ef, EF.EFStore)
    assert isinstance(tier.bm, CT.BitmapStore)
    srv = QueryServer(rt, engine="cuda", device="cpu", batch_window=8,
                      codec=tier)
    assert srv.engine.tier is tier
    ref = ServerJax(rj, engine="jnp", batch_window=8, codec=tj)
    _serve_and_compare(srv, ref, lists, rj.universe)


# -- selection and caching ---------------------------------------------------

def test_codec_mode_env_and_bogus(corpus, monkeypatch):
    _, _, rt = corpus
    assert CT.codec_mode("ef") == "ef"
    monkeypatch.setenv("REPRO_CODEC", "bitmap")
    assert CT.codec_mode(None) == CTJ.codec_mode(None) == "bitmap"
    assert CT.codec_mode("adaptive") == "adaptive"   # arg beats env
    eng = CudaEngine(rt, device="cpu")
    assert eng.tier.mode == "bitmap"
    assert QueryServer(rt, engine="host").engine.tier.mode == "bitmap"
    monkeypatch.delenv("REPRO_CODEC")
    assert CT.codec_mode(None) == "repair"
    assert HostEngine(rt).tier is None
    monkeypatch.setenv("REPRO_CODEC", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        CT.codec_mode(None)
    with pytest.raises(ValueError, match="bogus"):
        TorchEngine(rt, device="cpu")
    monkeypatch.delenv("REPRO_CODEC")
    with pytest.raises(ValueError, match="REPRO_CODEC must be one of"):
        QueryServer(rt, engine="cuda", device="cpu", codec="lz4")


@pytest.mark.parametrize("name", ["host", "cuda"])
def test_ef_cache_lru_bound_and_version_key(corpus, name):
    _, _, rt = corpus
    eng = (HostEngine(rt, codec="ef") if name == "host"
           else CudaEngine(rt, device="cpu", codec="ef"))
    eng._ef_sel.maxsize = 2         # shrink the bound for the test
    lids = np.zeros(4, np.int32)
    xs = np.arange(4, dtype=np.int32)
    eng.dispatch_round(lids, xs, "svs")
    assert (eng.index_version, "ef") in eng._ef_sel
    # a version bump (what swap_index does) keys a fresh entry; the
    # bounded LRU retires older versions rather than growing
    for v in (1, 2, 3):
        eng.index_version = v
        eng.dispatch_round(lids, xs + v, "svs")
        assert (v, "ef") in eng._ef_sel
        assert len(eng._ef_sel) <= 2
    assert (0, "ef") not in eng._ef_sel


def test_ef_cache_flushed_on_swap(corpus):
    lists, _, rt = corpus
    srv = QueryServer(rt, engine="cuda", device="cpu", codec="adaptive")
    before = srv.search("0")
    srv.engine.next_geq_batch(np.zeros(4, np.int32),
                              np.arange(4, dtype=np.int32))
    new_lists = [np.unique(l // 2) for l in lists]
    new_res = repair_compress(new_lists)
    srv.swap_index(new_res)
    # fresh engine at the bumped version with an empty pack cache; codec
    # selection re-ran over the new index
    assert srv.engine.index_version == srv.version == 1
    assert len(srv.engine._ef_sel) == 0
    assert srv.engine.tier is not None and srv.engine.tier.mode == "adaptive"
    from repro_torch.query import Term
    np.testing.assert_array_equal(
        srv.search("0"), naive_eval(Term(0), new_lists, new_res.universe))
    np.testing.assert_array_equal(before, lists[0])


def test_launcher_codec_tier(capsys):
    """``--codec`` on the launcher: the tier's counts and bits per posting
    are printed, every spot check passes."""
    launch.serve_queries(16, engine="cuda", device="cpu", concurrency=4,
                         topk=5, num_docs=150, vocab=200, seed=1,
                         codec="adaptive")
    out = capsys.readouterr().out
    assert "codec tier [adaptive]" in out and "bits/posting" in out
    assert "ranked spot checks OK" in out


# -- list-sharded (tests/test_query_plan.py:185, its fourth engine) ----------

@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("codec", TIERED)
def test_mixed_codecs_sharded(corpus, codec, shards):
    """Every codec assignment under a mesh: Re-Pair probes sharded, EF and
    bitmap probes replicated; the planner's, svs and bys answers equal the
    oracle and the JAX package's 1-device-mesh engine, and the ranked
    workload stays bit-identical."""
    import jax
    from jax.sharding import Mesh as MeshJax
    from repro.query import QueryExecutor as ExecJax

    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    from repro_torch.query import QueryExecutor, search_topk
    lists, rj, rt = corpus
    eng = TorchEngine(rt, max_short_len=MAX_SHORT, device="cpu", codec=codec,
                      mesh=Mesh(["cpu"] * shards))
    ref = JnpEngine(rj, max_short_len=MAX_SHORT, codec=codec,
                    mesh=MeshJax(np.array(jax.devices()[:1]), ("data",)))
    qj, qt, bags = _workloads(lists, 10, 4)
    D.reset_dispatches()
    for algo in (None, "svs", "bys"):
        ex, exj = (QueryExecutor(eng, force_algo=algo),
                   ExecJax(ref, force_algo=algo))
        for q, j in zip(qt, qj):
            got = ex.search(q)
            np.testing.assert_array_equal(got, exj.search(j),
                                          err_msg=f"{algo} {q!r}")
            np.testing.assert_array_equal(got,
                                          naive_eval(q, lists, rj.universe))
    for bag in bags:
        got = search_topk(eng, bag, 10)
        od, osc = rank_oracle(lists, rj.universe, bag, 10)
        np.testing.assert_array_equal(got.docs, od)
        np.testing.assert_array_equal(got.scores, osc)
    if eng.tier.counts()["repair"]:        # forced ef / bitmap have none
        assert D.DISPATCHES["sharded_next_geq"] > 0
