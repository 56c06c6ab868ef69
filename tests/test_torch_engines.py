"""Engine parity between the port and the JAX package.

Every engine-API operation of the port's engines must return exactly what
the JAX package's counterpart returns on the same postings:

* ``TorchEngine`` (flat, and paged at page 128) against ``JnpEngine``;
* ``CudaEngine(device="cpu")`` — the plain versions of ``list_intersect``
  and ``page_score`` behind the copied router — against
  ``PallasEngine(interpret=True)``, at page 2048 and at page 128;
* the port's ``HostEngine`` copy against the original.

Doc ids, next_geq values and the merged-round lane ledger are compared
exactly, BM25 scores bit for bit.
"""

import numpy as np
import pytest
import torch

from strategies import adversarial_lists

from repro.core.repair import repair_compress as repair_jax
from repro.engine import HostEngine as JHost, JnpEngine, PallasEngine
from repro.query import search_topk as search_topk_jax

from repro_torch.core.index import INT_INF
from repro_torch.core.repair import repair_compress
from repro_torch.engine import (ENGINES, CudaEngine, HostEngine, TorchEngine,
                                make_engine)
from repro_torch.query import rank_oracle, search_topk

MAX_SHORT = 64
PAIRS = ("host", "torch", "torch_paged128", "cuda", "cuda_paged128")


@pytest.fixture(scope="module")
def elists():
    """Random lists plus the edge shapes: a singleton, a 2-element list
    at the universe edges and a disjoint pair (ids 10..13), and a long
    dense run so that page 128 splits lists across pages."""
    return (adversarial_lists(np.random.default_rng(2024), universe=3000,
                              max_len=120)
            + [np.arange(40, 2900, 3, dtype=np.int64)])


@pytest.fixture(scope="module")
def results(elists):
    return repair_jax(elists), repair_compress(elists)


def _make(name, rj, rt, **kw):
    """(port engine, JAX-package engine) of one configuration."""
    dev = dict(max_short_len=MAX_SHORT, device="cpu")
    if name == "host":
        return HostEngine(rt), JHost(rj)
    if name == "torch":
        return (TorchEngine(rt, **dev, **kw),
                JnpEngine(rj, max_short_len=MAX_SHORT, **kw))
    if name == "torch_paged128":
        return (TorchEngine(rt, paged=True, page_size=128, **dev, **kw),
                JnpEngine(rj, max_short_len=MAX_SHORT, paged=True,
                          page_size=128, **kw))
    page = 128 if name == "cuda_paged128" else 2048
    return (CudaEngine(rt, page_size=page, **dev, **kw),
            PallasEngine(rj, max_short_len=MAX_SHORT, page_size=page,
                         interpret=True, **kw))


@pytest.fixture(scope="module", params=PAIRS)
def pair(request, results):
    return request.param, *_make(request.param, *results)


def _oracle(lists, lids, xs):
    out = []
    for t, x in zip(lids.tolist(), xs.tolist()):
        p = int(np.searchsorted(lists[t], x))
        out.append(int(lists[t][p]) if p < len(lists[t]) else int(INT_INF))
    return np.asarray(out, np.int64)


def _lanes(lists, universe, n=160, seed=1):
    rng = np.random.default_rng(seed)
    lids = list(rng.integers(0, len(lists), n))
    xs = list(rng.integers(0, universe + universe // 2, n))
    for t, arr in enumerate(lists):
        for x in (0, arr[0], arr[-1], arr[-1] + 1):
            lids.append(t)
            xs.append(int(x))
    return np.asarray(lids, np.int32), np.asarray(xs, np.int32)


def test_next_geq_member_bys_parity(pair, elists, results):
    name, port, ref = pair
    lids, xs = _lanes(elists, results[1].universe)
    got = port.next_geq_batch(lids, xs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.next_geq_batch(lids, xs))
    np.testing.assert_array_equal(got, _oracle(elists, lids, xs))
    np.testing.assert_array_equal(port.member_batch(lids, xs),
                                  ref.member_batch(lids, xs))
    np.testing.assert_array_equal(port.next_geq_bys_batch(lids, xs),
                                  ref.next_geq_bys_batch(lids, xs))


def test_intersections_parity(pair, elists):
    name, port, ref = pair
    rng = np.random.default_rng(3)
    L = len(elists)
    pairs = [tuple(map(int, rng.choice(L, 2, replace=False)))
             for _ in range(10)] + [(12, 13), (10, 0), (11, 10), (14, 3)]
    got, want = port.intersect_pairs(pairs), ref.intersect_pairs(pairs)
    for (a, b), g, w in zip(pairs, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {a},{b}")
        np.testing.assert_array_equal(g, np.intersect1d(elists[a],
                                                        elists[b]))
    for q in ([], [0], [10, 1], [2, 5, 8], [14, 1, 4], [12, 13, 0]):
        np.testing.assert_array_equal(port.intersect_multi(q),
                                      ref.intersect_multi(q))
        np.testing.assert_array_equal(port.intersect_multi_meld(q),
                                      ref.intersect_multi_meld(q))
    for i in (0, 10, 14):
        np.testing.assert_array_equal(port.decode_list(i), elists[i])


def _ledger_delta(eng, fn):
    before = dict(eng.lane_stats)
    out = fn()
    return out, {k: eng.lane_stats[k] - before[k] for k in before}


@pytest.mark.parametrize("algo", ["svs", "bys"])
def test_dispatch_round_lane_ledger(pair, elists, results, algo):
    """Merged rounds with duplicate lanes: the same values and the same
    lane ledger (real / unique / pad / dispatched lanes, memo hits) as the
    JAX package, on a first round and on its memo-served repeat."""
    name, port, ref = pair
    lids, xs = _lanes(elists, results[1].universe, n=37, seed=10 + len(algo))
    lids = np.concatenate([lids, lids[:21]])
    xs = np.concatenate([xs, xs[:21]])
    for _ in range(2):
        got, d_port = _ledger_delta(
            port, lambda: port.dispatch_round(lids, xs, algo))
        want, d_ref = _ledger_delta(
            ref, lambda: ref.dispatch_round(lids, xs, algo))
        np.testing.assert_array_equal(got, want)
        assert d_port == d_ref, name


def test_ranked_parity(pair, elists, results):
    """Page-entry decode of the whole block-max directory, score_batch,
    and top-k (pruned and exhaustive) equal the JAX package's, scores bit
    for bit; the merged ScoreRound ledger matches too."""
    name, port, ref = pair
    si = port.score_index
    assert si.page_size == ref.score_index.page_size
    entries = np.arange(si.pg_list.size, dtype=np.int32)
    np.testing.assert_array_equal(port.decode_page_batch(entries),
                                  ref.decode_page_batch(entries))
    rows, d_port = _ledger_delta(
        port, lambda: port.dispatch_score_round(entries[::-1][:11]))
    rows_j, d_ref = _ledger_delta(
        ref, lambda: ref.dispatch_score_round(entries[::-1][:11]))
    np.testing.assert_array_equal(rows, rows_j)
    assert d_port == d_ref
    docs = np.arange(0, results[1].universe, 7)
    bag = [0, 3, 14]
    np.testing.assert_array_equal(
        port.score_batch(docs, bag).view(np.uint32),
        ref.score_batch(docs, bag).view(np.uint32))
    for bag, k in (([0, 3, 14], 10), ([14, 5], 3), ([10, 11], 5)):
        for prune in (True, False):
            got = search_topk(port, bag, k, prune=prune)
            want = search_topk_jax(ref, bag, k, prune=prune)
            np.testing.assert_array_equal(got.docs, want.docs)
            np.testing.assert_array_equal(got.scores.view(np.uint32),
                                          want.scores.view(np.uint32))
            assert (got.pages_scored, got.pages_skipped) == \
                (want.pages_scored, want.pages_skipped)
            od, osc = rank_oracle(elists, results[1].universe, bag, k)
            np.testing.assert_array_equal(got.docs, od)
            np.testing.assert_array_equal(got.scores, osc)


def test_cuda_engine_long_short_side(results, elists):
    """Pairs and k-term queries whose short side is longer than one probe
    row stay on the engine: the short list is expanded whole and cut into
    rows of ``max_short_len`` probes, and the answers are exact."""
    eng = CudaEngine(results[1], max_short_len=4, device="cpu")
    big = sorted(range(len(elists)), key=lambda i: -len(elists[i]))[:3]
    pairs = [tuple(big[:2]), (big[1], big[2]), (12, big[0]), (big[0], 10)]
    for (a, b), got in zip(pairs, eng.intersect_pairs(pairs)):
        np.testing.assert_array_equal(got, np.intersect1d(elists[a],
                                                          elists[b]))
    want = np.intersect1d(np.intersect1d(elists[big[0]], elists[big[1]]),
                          elists[big[2]])
    np.testing.assert_array_equal(eng.intersect_multi(big), want)
    assert eng._expand_rows(big[0]).shape == (
        -(-len(elists[big[0]]) // 4), 4)


def test_cuda_engine_scores_through_page_score_at_page_128(
        results, elists, monkeypatch):
    """At page 128 the score directory is cut at the engine's own pages,
    every ScoreRound decodes through the ``page_score`` wrapper, and top-k
    equals the oracle."""
    import repro_torch.kernels.page_score.ops as PS
    calls = []
    wrapped = PS.page_score

    def counting(*a, **kw):
        calls.append(int(a[0].shape[0]))
        return wrapped(*a, **kw)

    monkeypatch.setattr(PS, "page_score", counting)
    eng = CudaEngine(results[1], device="cpu", page_size=128)
    assert eng.score_index.page_size == eng.pi.page_size == 128
    got = search_topk(eng, [0, 14], 3)
    od, osc = rank_oracle(elists, results[1].universe, [0, 14], 3)
    np.testing.assert_array_equal(got.docs, od)
    np.testing.assert_array_equal(got.scores, osc)
    assert len(calls) == got.pages_scored > 0


def test_registry_and_unported_options(results, monkeypatch):
    assert set(ENGINES) == {"host", "torch", "cuda"}
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("jnp", results[1])
    eng = make_engine("torch", results[1], device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.fi.c.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="codec"):
        make_engine("cuda", results[1], device="cpu", codec="ef")
    with pytest.raises(NotImplementedError, match="store"):
        make_engine("host", results[1], store="mmap")
    monkeypatch.setenv("REPRO_CODEC", "adaptive")
    with pytest.raises(NotImplementedError, match="codec"):
        make_engine("torch", results[1], device="cpu")
    monkeypatch.setenv("REPRO_CODEC", "repair")
    monkeypatch.setenv("REPRO_STORE", "memory")
    with pytest.raises(NotImplementedError, match="store"):
        make_engine("torch", results[1], device="cpu")
