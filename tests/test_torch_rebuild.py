"""Index refresh of the port against the JAX package (CPU).

A port ``QueryServer`` (engine ``cuda`` on the CPU) and a JAX-package
``QueryServer`` serve the same collection, then both ``rebuild`` from the
same grown postings — the port with its ``torch`` and ``cuda`` builders,
``repro`` with ``jnp`` — and serve the same boolean and ranked workloads:
answers must equal each other and the oracles, and the index version must
move.  The port's ``PostingsSource`` yields ``repro``'s documents, and the
launcher's refresh loop runs end to end.
"""

import numpy as np
import pytest
import torch

from benchmarks.common import boolean_workload as boolean_jax
from benchmarks.common import ranked_workload as ranked_jax
from repro.core.repair import repair_compress as repair_jax
from repro.data.pipeline import PostingsSource as SourceJax
from repro.serve.query_serve import QueryServer as ServerJax

from repro_torch.build import CudaBuilder, make_builder
from repro_torch.core.repair import repair_compress
from repro_torch.data import PostingsSource
from repro_torch.launch import serve as launch
from repro_torch.query import naive_eval, rank_oracle
from repro_torch.serve import QueryServer

SEED = 7


@pytest.fixture(scope="module")
def snapshots():
    """Versions 0 and 1 of a postings feed (version 1 grows version 0)."""
    src = PostingsSource(base_docs=160, growth_docs=80, vocab=240,
                         mean_doc_len=24, seed=SEED)
    (v0, _), (v1, _) = src.lists_at(0), src.lists_at(1)
    return v0, v1


@pytest.mark.parametrize("version", [0, 1, 3])
def test_postings_source_matches_repro(version):
    kw = dict(base_docs=50, growth_docs=20, vocab=120, mean_doc_len=16,
              seed=SEED)
    port, ref = PostingsSource(**kw), SourceJax(**kw)
    for a, b in zip(port.deltas_at(version), ref.deltas_at(version)):
        np.testing.assert_array_equal(a, b)
    (pl, pn), (rl, rn) = port.lists_at(version), ref.lists_at(version)
    assert pn == rn == port.num_docs_at(version) and len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("builder", ["torch", "cuda"])
def test_rebuild_serves_like_repro(snapshots, builder):
    """rebuild() with the port's device builder on the CPU == repro's
    rebuild(builder="jnp"): same grammar, same answers, version moved."""
    v0, v1 = snapshots
    srv = QueryServer(repair_compress(v0), engine="cuda", device="cpu",
                      batch_window=8)
    ref = ServerJax(repair_jax(v0), engine="jnp", batch_window=8)
    assert srv.version == ref.version == 0
    bld = builder if builder == "torch" else CudaBuilder(table_cap=4096,
                                                         device="cpu")
    got_res = srv.rebuild(v1, builder=bld)
    want_res = ref.rebuild(v1, builder="jnp")
    assert srv.version == ref.version == 1
    assert srv.engine.index_version == 1
    np.testing.assert_array_equal(got_res.seq, want_res.seq)
    np.testing.assert_array_equal(got_res.grammar.rules,
                                  want_res.grammar.rules)
    lengths = [len(l) for l in v1]
    qs = launch.boolean_workload(len(v1), lengths, n_queries=32, seed=SEED)
    qj = boolean_jax(len(v1), lengths, n_queries=32, seed=SEED)
    got, want = srv.search_many(qs), ref.search_many(qj)
    universe = got_res.universe
    for q, g, w in zip(qs, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, naive_eval(q, v1, universe))
    bags = launch.ranked_workload(len(v1), lengths, n_queries=8, seed=SEED)
    assert bags == ranked_jax(len(v1), lengths, n_queries=8, seed=SEED)
    for bag, g, w in zip(bags, srv.search_topk_many(bags, 5),
                         ref.search_topk_many(bags, 5)):
        np.testing.assert_array_equal(g.docs, w.docs)
        np.testing.assert_array_equal(g.scores, w.scores)
        docs, scores = rank_oracle(v1, universe, bag, 5)
        np.testing.assert_array_equal(g.docs, docs)
        np.testing.assert_array_equal(g.scores, scores)


def test_rebuild_default_builder_on_server_device(snapshots):
    """A builder named by string runs on the server's device (the CPU
    here); the default is the torch builder at the default config."""
    v0, v1 = snapshots
    srv = QueryServer(repair_compress(v0), engine="torch", device="cpu")
    res = srv.rebuild(v1)
    assert srv.version == 1
    want = repair_compress(v1)
    np.testing.assert_array_equal(res.grammar.rules, want.grammar.rules)
    np.testing.assert_array_equal(res.starts, want.starts)
    np.testing.assert_array_equal(srv.search("3 AND 5"),
                                  np.intersect1d(v1[3], v1[5]))
    srv.rebuild(v0, builder="cuda", build_cfg=None)
    assert srv.version == 2
    np.testing.assert_array_equal(srv.search("3 AND 5"),
                                  np.intersect1d(v0[3], v0[5]))


def test_rebuild_needs_a_card_unless_cpu(monkeypatch, snapshots):
    """A server with the host engine keeps the default device "cuda":
    rebuilding with a device builder raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v0, v1 = snapshots
    srv = QueryServer(repair_compress(v0), engine="host")
    for name in ("torch", "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            srv.rebuild(v1, builder=name)
    srv.rebuild(v1, builder="host")
    assert srv.version == 1
    srv.rebuild(v1, builder=make_builder("torch", device="cpu"))
    assert srv.version == 2


@pytest.mark.parametrize("builder", ["torch", "cuda"])
def test_launcher_refreshes(capsys, builder):
    """The launcher builds with a device builder, then grows, rebuilds and
    hot-swaps twice, checking answers after each swap."""
    launch.serve_queries(8, engine="cuda", device="cpu", num_docs=120,
                         vocab=160, seed=1, builder=builder, refreshes=2)
    out = capsys.readouterr().out
    assert f"[{builder}] Re-Pair built" in out
    for v in (1, 2):
        assert f"refresh v{v}: +500 docs" in out
        assert f"index version {v}), serving verified" in out


def test_launcher_data_shards_refresh_growth_docs(capsys, monkeypatch):
    """``repro``'s spelling of the launcher's flags: ``--data-shards 1
    --refresh 1 --growth-docs 50`` on the CPU (the CPU is one device),
    and ``--refreshes`` as an alias; past the device count it exits."""
    base = ["serve", "--engine", "cuda", "--device", "cpu", "--n", "8",
            "--num-docs", "120", "--vocab", "160", "--seed", "1"]
    monkeypatch.setattr("sys.argv", base + [
        "--concurrency", "4", "--topk", "5", "--data-shards", "1",
        "--refresh", "1", "--growth-docs", "50", "--ingest-rate", "3"])
    launch.main()
    out = capsys.readouterr().out
    assert "list-sharded dispatch over data axis: 1 device(s)" in out
    assert "refresh v1: +50 docs" in out
    assert "index version 1), serving verified" in out
    assert "ingest gate OK" in out
    monkeypatch.setattr("sys.argv", base + ["--refreshes", "1"])
    launch.main()
    assert "refresh v1: +500 docs" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", base + ["--data-shards", "2"])
    with pytest.raises(SystemExit, match="--data-shards 2 > 1 available"):
        launch.main()
