"""The port's serving slice end to end, against the JAX package.

One Zipf collection is compressed once by the JAX package's host Re-Pair;
its ``RePairResult`` is carried into the port as numpy arrays.  A port
``QueryServer`` (engine ``cuda`` on the CPU, i.e. the kernels' plain
versions, and engine ``torch``) and a JAX-package ``QueryServer`` then run
the same ``boolean_workload`` and ``ranked_workload`` streams
(``benchmarks/common.py`` and the port's copies of them): per-query doc
ids, top-k order and float32 scores must be identical, serially and
coalesced at concurrency 8, at page 2048 and at page 128.
"""

import numpy as np
import pytest

from benchmarks.common import boolean_workload as boolean_jax
from benchmarks.common import ranked_workload as ranked_jax
from repro.core.repair import repair_compress as repair_jax
from repro.serve.query_serve import QueryServer as ServerJax

from repro_torch.core.repair import (repair_compress,
                                     repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.index.corpus import zipf_corpus
from repro_torch.launch import serve as launch
from repro_torch.query import naive_eval, rank_oracle
from repro_torch.serve import QueryServer

SEED = 5


@pytest.fixture(scope="module")
def corpus():
    """Postings, the JAX package's result, and the same result carried
    into the port."""
    lists = zipf_corpus(num_docs=400, vocab_size=500, mean_doc_len=30,
                        seed=SEED).postings()
    rj = repair_jax(lists)
    arrays, statics = repair_result_to_arrays(rj)
    return lists, rj, repair_result_from_arrays(arrays, statics)


def _workloads(lists, n_bool, n_ranked):
    lengths = [len(l) for l in lists]
    qj = boolean_jax(len(lists), lengths, n_queries=n_bool, seed=SEED)
    qt = launch.boolean_workload(len(lists), lengths, n_queries=n_bool,
                                 seed=SEED)
    assert [repr(q) for q in qj] == [repr(q) for q in qt]
    bj = ranked_jax(len(lists), lengths, n_queries=n_ranked, seed=SEED)
    bt = launch.ranked_workload(len(lists), lengths, n_queries=n_ranked,
                                seed=SEED)
    assert bj == bt
    return qj, qt, bt


@pytest.fixture(scope="module", params=[2048, 128])
def servers(request, corpus):
    _, rj, rt = corpus
    page = request.param
    engines = ("cuda", "torch")
    ref = {name: ServerJax(rj, engine="jnp", paged=True, page_size=page,
                           batch_window=8) for name in engines}
    port = {name: QueryServer(rt, engine=name, device="cpu", paged=True,
                              page_size=page, batch_window=8)
            for name in engines}
    return page, ref, port


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_boolean_workload_identical(servers, corpus, engine):
    """search_many at concurrency 8 and one-at-a-time search: the port's
    answers equal the JAX package's and the set oracle; the coalesced
    rounds carry the same lane ledger."""
    _, refs, port = servers
    lists, rj, _ = corpus
    srv, ref = port[engine], refs[engine]
    qj, qt, _ = _workloads(lists, 48, 0)
    got = srv.search_many(qt)
    want = ref.search_many(qj)
    assert len(got) == len(want) == len(qt)
    for q, g, w in zip(qt, got, want):
        np.testing.assert_array_equal(g, w, err_msg=repr(q))
        np.testing.assert_array_equal(g, naive_eval(q, lists, rj.universe))
    st, sj = srv.serve_stats(), ref.serve_stats()
    for key in ("completed", "real_lanes", "unique_lanes", "pad_lanes"):
        assert st[key] == sj[key], key
    assert st["coalescing_factor"] > 1.0
    for q, w in zip(qt[:8], want):
        np.testing.assert_array_equal(srv.search(q), w)


def test_ranked_workload_identical(servers, corpus):
    """search_topk_many (coalesced) and search_topk: identical docs,
    order, bit-identical float32 scores and page accounting."""
    page, refs, port = servers
    ref = refs["cuda"]
    lists, rj, _ = corpus
    _, _, bags = _workloads(lists, 0, 12)
    for k in (10, 3):
        got = port["cuda"].search_topk_many(bags, k)
        want = ref.search_topk_many(bags, k)
        for bag, g, w in zip(bags, got, want):
            np.testing.assert_array_equal(g.docs, w.docs, err_msg=str(bag))
            np.testing.assert_array_equal(g.scores.view(np.uint32),
                                          w.scores.view(np.uint32))
            assert (g.pages_scored, g.pages_skipped) == \
                (w.pages_scored, w.pages_skipped)
            od, osc = rank_oracle(lists, rj.universe, bag, k)
            np.testing.assert_array_equal(g.docs, od)
            np.testing.assert_array_equal(g.scores, osc)
    one = port["torch"].search_topk(bags[0], 10, prune=False)
    np.testing.assert_array_equal(one.docs, ref.search_topk(
        bags[0], 10, prune=False).docs)
    eng = port["cuda"].engine
    assert eng.score_index.page_size == eng.pi.page_size == page


def test_server_point_api_identical(servers, corpus):
    _, refs, port = servers
    ref = refs["cuda"]
    lists, rj, rt = corpus
    srv = port["cuda"]
    rng = np.random.default_rng(SEED)
    lids = rng.integers(0, len(lists), 64).astype(np.int32)
    xs = rng.integers(0, rj.universe + 9, 64).astype(np.int32)
    np.testing.assert_array_equal(srv.next_geq_batch(lids, xs),
                                  ref.next_geq_batch(lids, xs))
    np.testing.assert_array_equal(srv.member_batch(lids, xs),
                                  ref.member_batch(lids, xs))
    pairs = [tuple(map(int, rng.choice(len(lists), 2, replace=False)))
             for _ in range(6)]
    for g, w in zip(srv.and_batch(pairs), ref.and_batch(pairs)):
        np.testing.assert_array_equal(g, w)
    multi = [[0, 1, 2], [5], [3, 9, 12, 20]]
    for g, w in zip(srv.and_multi(multi), ref.and_multi(multi)):
        np.testing.assert_array_equal(g, w)
    q = "(0 AND 1) OR NOT 2"
    assert srv.explain(q) == ref.explain(q)
    qid = srv.submit(q)
    srv.scheduler.drain()
    np.testing.assert_array_equal(srv.scheduler.take(qid), ref.search(q))


def test_swap_index_serves_new_index(corpus):
    """A hot swap bumps the version and serves the new postings."""
    lists, _, rt = corpus
    srv = QueryServer(rt, engine="cuda", device="cpu")
    before = srv.search("0 AND 1")
    smaller = [l[: max(1, len(l) // 2)] for l in lists]
    srv.swap_index(repair_compress(smaller))
    assert srv.version == 1 and srv.engine.index_version == 1
    np.testing.assert_array_equal(srv.search("0 AND 1"),
                                  np.intersect1d(smaller[0], smaller[1]))
    assert before.size >= srv.search("0 AND 1").size


def test_launcher_queries_tier(capsys):
    """The launcher's queries tier runs end to end on the CPU and checks
    itself against the oracles."""
    launch.serve_queries(16, engine="cuda", device="cpu", concurrency=4,
                         topk=5, query="(0 AND 1) OR 2", num_docs=150,
                         vocab=200, seed=1)
    out = capsys.readouterr().out
    assert "spot checks OK" in out
    assert "ranked spot checks OK" in out
    assert "oracle-verified" in out
