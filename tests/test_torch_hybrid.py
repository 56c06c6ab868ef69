"""The port's [MC07] hybrid query engine and quickstart flow against the
JAX package (CPU).

``repro_torch.index.HybridQueryEngine`` over the port's ``build_index``
must answer exactly as ``repro.index.HybridQueryEngine`` over
``repro``'s, for every method (``merge``, ``skip``, ``svs``, ``lookup``
and the byte codes ``vbyte``, ``rice``), with and without the hybrid
bitmaps, on the conftest lists: pairs (every bitmap / compressed route),
k-term conjunctions (the candidate-filter path), disjunctions and phrase
skeletons with a verifier.  Both indexes must also be the same index.
Last, ``repro_torch.launch.quickstart.main(device="cpu")`` prints what
``examples/quickstart.py`` prints, but for its construction section,
which builds with the port's ``torch`` builder where the original uses
``jnp``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.index import HybridQueryEngine as HybridJax
from repro.index import build_index as build_index_jax

import repro_torch.index as port_index
from repro_torch.index import HybridQueryEngine, build_index
from repro_torch.launch import quickstart

METHODS = ("merge", "skip", "svs", "lookup", "vbyte", "rice")
ROOT = Path(__file__).resolve().parents[1]


def test_index_exports_match_repro():
    import repro.index
    assert set(port_index.__all__) == set(repro.index.__all__)
    assert {"HybridQueryEngine", "pack_documents"} <= set(port_index.__all__)


@pytest.fixture(scope="module", params=[False, True],
                ids=["pure", "hybrid_bitmaps"])
def indexes(request, lists):
    u = max(int(l[-1]) for l in lists) + 1
    kw = dict(hybrid_bitmaps=request.param, bitmap_threshold_div=8,
              codecs=("vbyte", "rice"))
    ours = build_index(lists, u, device="cpu", **kw)
    ref = build_index_jax(lists, u, **kw)
    assert ours.bitmap_idx == ref.bitmap_idx
    assert bool(ref.bitmaps) == request.param
    for i, bm in ref.bitmaps.items():
        np.testing.assert_array_equal(ours.bitmaps[i].words, bm.words)
    np.testing.assert_array_equal(ours.repair.seq, ref.repair.seq)
    assert ours.space_report() == ref.space_report()
    return ours, ref


def _queries(n_lists, seed):
    rng = np.random.default_rng(seed)
    pairs = [[int(x) for x in rng.choice(n_lists, 2, replace=False)]
             for _ in range(20)]
    multi = [[int(x) for x in rng.choice(n_lists, int(rng.integers(3, 5)),
                                         replace=False)] for _ in range(10)]
    return pairs + multi + [[], [3]]


@pytest.mark.parametrize("method", METHODS)
def test_hybrid_engine_matches_repro(indexes, lists, method):
    ours, ref = indexes
    qe, qr = HybridQueryEngine(ours, method=method), HybridJax(ref,
                                                               method=method)

    def verifier(d, ids):
        return d % 3 != 0

    for q in _queries(len(lists), seed=len(method)):
        got = qe.conjunctive(q)
        np.testing.assert_array_equal(got, qr.conjunctive(q))
        want = (np.unique(np.concatenate([lists[i] for i in q])) if q
                else np.empty(0, np.int64))
        for i in q:
            want = np.intersect1d(want, lists[i])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(qe.disjunctive(q), qr.disjunctive(q))
        np.testing.assert_array_equal(qe.phrase(q, verifier),
                                      qr.phrase(q, verifier))


def test_hybrid_engine_unknown_method(indexes):
    ours, _ = indexes
    with pytest.raises(ValueError, match="unknown method"):
        HybridQueryEngine(ours, method="bogus").conjunctive([0, 1])


def _reference_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_example", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_quickstart_matches_example(capsys):
    quickstart.main(device="cpu")
    ours = capsys.readouterr().out.splitlines()
    _reference_quickstart()()
    ref = capsys.readouterr().out.splitlines()
    assert ours[-1] == ref[-1] == "quickstart OK"
    assert len(ours) == len(ref)
    build = [i for i, line in enumerate(ref)
             if line.startswith("=== device-side construction")][0]
    for i, (a, b) in enumerate(zip(ours, ref)):
        if i == build:
            assert a.startswith("=== device-side construction on cpu")
        elif i == build + 1:
            assert a.startswith("torch builder:") and b.startswith(
                "jnp builder:")
            assert a.split(" — ")[0].split(":")[1] == \
                b.split(" — ")[0].split(":")[1]
        else:
            assert a == b
