"""The benchmark's frozen inputs and its plain reference, held to the port.

* the frozen ``zipf_corpus`` / ``postings`` give the port's corpus, and
  the frozen query generators the port's query streams, whose strings
  parse back to the port's trees;
* the reference's answers equal ``QueryServer``'s on the CPU (its plain
  PyTorch versions) at seeds 0 and 1, boolean and ranked;
* the controls differ from the reference where they should.
"""

import itertools

import numpy as np
import pytest

from perfbench.corpus import postings, zipf_corpus
from perfbench.reference import (Bf16Reference, BloomReference, Reference,
                                 _bf16)
from perfbench.traffic import (QueryStream, boolean_workload,
                               ranked_workload, render)
from repro_torch.core.repair import repair_compress
from repro_torch.index.corpus import zipf_corpus as port_corpus
from repro_torch.launch.serve import boolean_workload as port_boolean
from repro_torch.launch.serve import ranked_workload as port_ranked
from repro_torch.query.ast import And, Not, Or, Phrase, Term
from repro_torch.query.parser import parse
from repro_torch.serve import QueryServer

SEEDS = (0, 1, 2**31 + 11)


def _tree(node):
    kind, arg = node
    if kind == "term":
        return Term(arg)
    if kind == "not":
        return Not(_tree(arg))
    if kind == "phrase":
        return Phrase(tuple(arg))
    return (And if kind == "and" else Or)(tuple(_tree(c) for c in arg))


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_corpus_is_the_ports(seed):
    kw = dict(num_docs=1500, vocab_size=2500, mean_doc_len=60)
    mine = zipf_corpus(seed=seed, **kw)
    port = port_corpus(seed=seed, **kw)
    assert len(mine) == len(port.doc_terms)
    assert all(np.array_equal(a, b) for a, b in zip(mine, port.doc_terms))
    got, want = postings(mine), port.postings()
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, want))


def test_frozen_corpus_at_the_cells_size():
    """Seed 0 at the configuration's size: 19,877 lists, 2,003,031
    postings, and a largest d-gap that leaves the builders' int32 pair
    key room for 4,096 rules."""
    lists = postings(zipf_corpus(num_docs=42000, vocab_size=20000, seed=0))
    assert (len(lists), sum(l.size for l in lists)) == (19877, 2003031)
    gap = max(int(np.diff(l, prepend=-1).max()) for l in lists)
    assert gap + 1 + 4096 <= 46340


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_streams_are_the_ports(seed):
    rng = np.random.default_rng(seed % 97)
    n_lists = 3000
    lengths = rng.integers(1, 800, n_lists)
    got = list(itertools.islice(boolean_workload(n_lists, lengths, seed),
                                1500))
    want = port_boolean(n_lists, lengths, n_queries=1500, seed=seed)
    assert [_tree(q) for q in got] == want
    assert [parse(render(q)) for q in got] == want
    got = list(itertools.islice(ranked_workload(n_lists, lengths, seed),
                                1500))
    assert got == port_ranked(n_lists, lengths, n_queries=1500, seed=seed)


def test_one_component_mix_is_its_generator():
    lengths = np.arange(500, 0, -1)
    tr = {"kind": "bool", "generator": {"zipf_s": 1.1}}
    s = QueryStream(tr, 500, lengths, 7)
    got = [next(s).query for _ in range(300)]
    assert got == list(itertools.islice(boolean_workload(500, lengths, 7),
                                        300))


@pytest.fixture(scope="module", params=(0, 1))
def small(request):
    seed = request.param
    lists = postings(zipf_corpus(num_docs=500, vocab_size=700,
                                 mean_doc_len=40, seed=seed))
    return seed, lists, repair_compress(lists)


@pytest.mark.parametrize("engine", ("torch", "cuda"))
def test_reference_equals_the_server_on_the_cpu(small, engine):
    seed, lists, res = small
    ref = Reference(lists, k1=0.9, b=0.4)
    assert ref.universe == res.universe
    srv = QueryServer(res, engine=engine, device="cpu", batch_window=16)
    lengths = [l.size for l in lists]
    bools = list(itertools.islice(boolean_workload(len(lists), lengths,
                                                   seed), 120))
    got = srv.search_many([render(q) for q in bools])
    for q, a in zip(bools, got):
        np.testing.assert_array_equal(a, ref.boolean(q), err_msg=render(q))
    bags = list(itertools.islice(ranked_workload(len(lists), lengths,
                                                 seed), 40))
    for bag, r in zip(bags, srv.search_topk_many(bags, 10)):
        docs, scores = ref.topk(bag, 10)
        np.testing.assert_array_equal(r.docs, docs)
        assert r.scores.dtype == np.float32
        np.testing.assert_array_equal(r.scores.view(np.uint32),
                                      scores.view(np.uint32))


def test_reference_edges(small):
    _, lists, _ = small
    ref = Reference(lists, k1=0.9, b=0.4)
    n = len(lists)
    assert ref.boolean(("term", n)).size == 0          # no such list
    assert ref.boolean(("term", -1)).size == 0
    both = ref.boolean(("phrase", (3, 3)))
    np.testing.assert_array_equal(both, lists[3])
    everything = ref.boolean(("or", (("term", 2), ("not", ("term", 2)))))
    np.testing.assert_array_equal(everything, np.arange(ref.universe))
    docs, scores = ref.topk([5, 5, n + 3], 10)         # dupes, OOV dropped
    d2, s2 = ref.topk([5], 10)
    np.testing.assert_array_equal(docs, d2)
    np.testing.assert_array_equal(scores, s2)
    assert ref.topk([], 10)[0].size == 0


def test_controls_differ_from_the_reference(small):
    seed, lists, _ = small
    ref = Reference(lists, 0.9, 0.4)
    bloom = BloomReference(lists, 0.9, 0.4)
    bf16 = Bf16Reference(lists, 0.9, 0.4)
    lengths = [l.size for l in lists]
    bools = list(itertools.islice(boolean_workload(len(lists), lengths,
                                                   seed), 200))
    wrong = sum(not np.array_equal(bloom.boolean(q), ref.boolean(q))
                for q in bools)
    assert wrong > 10
    # the filter only adds false positives to an AND, never drops a doc
    for q in bools:
        if q[0] == "and" and all(c[0] == "term" for c in q[1]):
            assert np.isin(ref.boolean(q), bloom.boolean(q)).all()
    bags = list(itertools.islice(ranked_workload(len(lists), lengths,
                                                 seed), 50))
    wrong = sum(not np.array_equal(bf16.topk(b, 10)[1], ref.topk(b, 10)[1])
                for b in bags)
    assert wrong > 25


def test_bf16_rounding():
    x = np.asarray([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 3.14159, -2.5e-3],
                   np.float32)
    got = _bf16(x)
    # ties go to even; the low 16 bits are always clear
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 4 * 2**-8
    assert (got.view(np.uint32) & 0xFFFF == 0).all()
    assert np.allclose(got, x, rtol=2**-8)
