"""List-sharded serving of the port against the JAX package's.

``repro`` serves one index across the devices of a mesh: the grammar
replicates, the stream, spans and (b)-sampling are list-partitioned
(``shard_flat_index``), each device answers the lanes whose list it owns
and a ``pmax`` assembles the batch.  The port runs the same program over
a single-process :class:`repro_torch.distributed.Mesh`, whose entries may
repeat, so these tests run 1, 2, 3 and 5 shards on the CPU:

* ``shard_flat_index``'s stacks and routing tables equal ``repro``'s at
  1, 2, 3 and 5 shards, including more shards than lists;
* the port's sharded answers equal ``repro``'s ``shard_map`` answers on
  2 and 3 virtual CPU devices — ``repro`` runs in a subprocess started
  with ``XLA_FLAGS=--xla_force_host_platform_device_count=3`` (this
  suite's own process sees one JAX device) — and the oracle;
* each engine probes its shards as it probes unsharded: the torch
  engine with the flat program, the cuda engine with K1 over each
  shard's paged pack (here its plain version), and a shard that owns
  every list on the engine's device through the engine's own tables;
* the hazards: shards that own no list, an empty-stream segment, the -1
  and ``INT32_MAX`` sentinels, stale shards after a swap, and meshes the
  engine is not placed on.

The mesh cases of ``repro``'s serving tests sit beside the tests they
mirror in the port's other files (engines, serve, codec tier, dedup,
store, segment).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from strategies import adversarial_lists, make_lists

from repro.core import jax_index as JI
from repro.core.repair import repair_compress as repair_jax
from repro.distributed import sharding as SJ
from repro.engine.device import shard_flat_index as shard_jax

from repro_torch.core.index import INT_INF
from repro_torch.core.repair import (repair_compress,
                                     repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.distributed import Mesh
from repro_torch.distributed import sharding as ST
from repro_torch.engine import device as D
from repro_torch.engine import make_engine
from repro_torch.query import naive_eval, parse, rank_oracle
from repro_torch.serve import QueryServer

ROOT = Path(__file__).resolve().parents[1]
SEED = int(os.environ.get("REPRO_BENCH_SEED", "0"))
INF = int(INT_INF)


def _carry(rj):
    return repair_result_from_arrays(*repair_result_to_arrays(rj))


def _mesh(n):
    return Mesh(["cpu"] * n)


def _oracle(lists, lids, xs):
    out = []
    for t, x in zip(lids.tolist(), xs.tolist()):
        p = int(np.searchsorted(lists[t], x))
        out.append(int(lists[t][p]) if p < len(lists[t]) else INF)
    return np.asarray(out, np.int64)


def _lanes(lists, universe, n=200, seed=SEED):
    """Random lanes plus every list's head, tail, one past the tail and
    zero."""
    rng = np.random.default_rng(seed)
    lids = list(rng.integers(0, len(lists), n))
    xs = list(rng.integers(0, universe + 9, n))
    for t, v in enumerate(lists):
        for x in (0, v[0], v[-1], v[-1] + 1):
            lids.append(t)
            xs.append(int(x))
    return np.asarray(lids, np.int32), np.asarray(xs, np.int32)


@pytest.fixture(scope="module")
def slists():
    return make_lists(np.random.default_rng(SEED + 7), n_lists=24,
                      universe=3000, min_len=2, max_len=300)


@pytest.fixture(scope="module")
def sres(slists):
    rj = repair_jax(slists)
    return rj, _carry(rj)


# -- the mesh ------------------------------------------------------------------

def test_mesh_is_one_axis_of_devices():
    assert _mesh(3).size == 3
    assert _mesh(2).devices == (torch.device("cpu"),) * 2
    assert ST.INDEX_REPLICATED_FIELDS == SJ.INDEX_REPLICATED_FIELDS
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])


# -- shard_flat_index ----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """Three lists: five shards are more shards than lists."""
    lists = [np.asarray(v, np.int64) for v in
             ([1, 4, 9, 16, 25, 36, 49], [2, 3, 5, 7, 11, 13], [8, 9, 10])]
    rj = repair_jax(lists)
    return lists, rj, _carry(rj)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
@pytest.mark.parametrize("which", ["lists", "tiny"])
def test_shard_flat_index_equals_repro(which, num_shards, sres, tiny):
    rj, rt = sres if which == "lists" else tiny[1:]
    fj = JI.build_flat_index(rj)
    ft = make_engine("torch", rt, device="cpu").fi
    sj, ofj, llj = shard_jax(fj, num_shards)
    st, oft, llt = D.shard_flat_index(ft, num_shards)
    assert sorted(st) == sorted(sj) == sorted(D._STACKED_FIELDS)
    for k in st:
        assert st[k].dtype == np.int32
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_array_equal(oft, np.asarray(ofj))
    np.testing.assert_array_equal(llt, np.asarray(llj))
    if which == "tiny" and num_shards == 5:
        assert np.bincount(oft, minlength=5).min() == 0   # an empty shard


# -- sharded answers against repro's shard_map on 2 and 3 devices --------------

_REPRO_SHARDED = """
import sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.core.jax_index import build_flat_index
from repro.core.repair import repair_compress
from repro.engine.device import make_sharded_next_geq

inp = np.load(sys.argv[1])
lists = [inp[f"l{i}"] for i in range(int(inp["n"]))]
fi = build_flat_index(repair_compress(lists))
assert len(jax.devices()) == 3, jax.devices()
out = {}
for n in (2, 3):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    call = make_sharded_next_geq(fi, mesh)
    out[f"n{n}"] = np.asarray(call(inp["lids"], inp["xs"]))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def repro_sharded(slists, sres, tmp_path_factory):
    """``repro``'s ``make_sharded_next_geq`` at 2 and 3 devices, run in a
    subprocess that gives JAX three virtual CPU devices."""
    rt = sres[1]
    lids, xs = _lanes(slists, rt.universe)
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "in.npz", n=len(slists), lids=lids, xs=xs,
             **{f"l{i}": v for i, v in enumerate(slists)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=3",
               PYTHONPATH=f"{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", _REPRO_SHARDED,
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    got = np.load(d / "out.npz")
    return lids, xs, {n: got[f"n{n}"] for n in (2, 3)}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_answers_equal_repro_shard_map(repro_sharded, slists, sres,
                                               n, engine):
    lids, xs, want = repro_sharded
    rt = sres[1]
    eng = make_engine(engine, rt, device="cpu", mesh=_mesh(n))
    D.reset_dispatches()
    got = eng.next_geq_batch(lids, xs)
    assert D.DISPATCHES["sharded_next_geq"] == 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want[n])
    np.testing.assert_array_equal(got, _oracle(slists, lids, xs))
    assert len(eng._sharded_next_geq.shards) == n


# -- hazards -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_shards_that_own_no_list(tiny, n):
    """More shards than lists: the empty shards' padded tables are read
    by every lane (as non-owners) and never past their ends."""
    lists, _, rt = tiny
    lids, xs = _lanes(lists, rt.universe, n=60)
    eng = make_engine("torch", rt, device="cpu", mesh=_mesh(n))
    sof = eng._sharded_next_geq.shard_of_list
    assert (np.bincount(sof, minlength=n) == 0).sum() == max(0, n - 3)
    np.testing.assert_array_equal(eng.next_geq_batch(lids, xs),
                                  _oracle(lists, lids, xs))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_empty_stream_segment(engine, n):
    """Every list a single posting (a one-document segment): the stream
    is empty, the port pads it with one unread terminal, and that padding
    survives the shards' zero fill."""
    lists = [np.asarray([d], np.int64) for d in (3, 0, 7, 7)]
    rt = repair_compress(lists)
    assert rt.seq.size == 0
    eng = make_engine(engine, rt, device="cpu", mesh=_mesh(n))
    assert D.shard_flat_index(eng.fi, n)[0]["c"].shape[1] >= 1
    for shard in eng._sharded_next_geq.shards:
        assert all(t.numel() >= 1 for t in shard["tables"].values())
    lids = np.repeat(np.arange(4, dtype=np.int32), 4)
    xs = np.tile(np.asarray([0, 3, 7, 8], np.int32), 4)
    np.testing.assert_array_equal(eng.next_geq_batch(lids, xs),
                                  _oracle(lists, lids, xs))


@pytest.mark.parametrize("n", [2, 3])
def test_sentinels(slists, sres, n):
    """Past-end answers are INT32_MAX, not the non-owners' -1: the max
    picks the owner's answer, in int32."""
    rt = sres[1]
    eng = make_engine("torch", rt, device="cpu", mesh=_mesh(n))
    L = len(slists)
    lids = np.arange(L, dtype=np.int32)
    past = np.asarray([v[-1] + 1 for v in slists], np.int32)
    got = eng.next_geq_batch(lids, past)
    assert got.dtype == np.int32 and (got == 2**31 - 1).all()
    heads = eng.next_geq_batch(lids, np.zeros(L, np.int32))
    np.testing.assert_array_equal(heads, [v[0] for v in slists])
    assert (eng.next_geq_batch(lids, np.full(L, INF, np.int32)) == INF).all()
    assert not (eng.next_geq_batch(*_lanes(slists, rt.universe)) == -1).any()


@pytest.mark.parametrize("n", [1, 2])
def test_swap_never_answers_from_old_shards(slists, sres, n):
    """Serve, swap to a different index, serve again: every answer is the
    new index's, and the shards are the new engine's own."""
    rt = sres[1]
    srv = QueryServer(rt, engine="torch", device="cpu", mesh=_mesh(n))
    old = srv.engine._sharded_next_geq
    np.testing.assert_array_equal(srv.search("0 AND 1"),
                                  np.intersect1d(slists[0], slists[1]))
    other = [np.unique(v * 2 + 1) for v in slists[::-1]]
    srv.swap_index(repair_compress(other))
    assert srv.engine._sharded_next_geq is not old
    lids, xs = _lanes(other, int(max(v[-1] for v in other)) + 1)
    np.testing.assert_array_equal(srv.next_geq_batch(lids, xs),
                                  _oracle(other, lids, xs))
    for q in ("0 AND 1", "(2 AND 3) OR NOT 4"):
        np.testing.assert_array_equal(
            srv.search(q), naive_eval(parse(q, None), other,
                                      srv.res.universe))
    rr = srv.search_topk([0, 1, 2], 5)
    od, osc = rank_oracle(other, srv.res.universe, [0, 1, 2], 5)
    np.testing.assert_array_equal(rr.docs, od)
    np.testing.assert_array_equal(rr.scores, osc)


def test_placement_mismatch_raises(sres):
    """A mesh that does not hold the engine's device raises; nothing is
    moved silently."""
    rt = sres[1]
    with pytest.raises(ValueError, match="not a device of the mesh"):
        make_engine("torch", rt, device="cpu",
                    mesh=Mesh(["cuda:0"]))
    with pytest.raises(ValueError, match="not a device of the mesh"):
        QueryServer(rt, engine="cuda", device="cpu",
                    mesh=Mesh(["cuda", "cuda"]))


def test_host_engine_ignores_the_mesh_and_the_launcher_refuses_it(sres):
    """As in ``repro``, the host engine has no mesh; the launcher says so
    rather than print a sharded dispatch that never runs."""
    from repro_torch.launch import serve as launch
    srv = QueryServer(sres[1], engine="host", mesh=_mesh(2))
    assert not hasattr(srv.engine, "_sharded_next_geq")
    with pytest.raises(SystemExit, match="host engine has no mesh"):
        launch.serve_queries(4, engine="host", device="cpu", num_docs=40,
                             vocab=60, data_shards=1)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_each_engine_probes_its_shards_as_it_probes_unsharded(slists, sres,
                                                              n):
    """The torch engine's shards hold flat tables and run the flat
    program; the cuda engine's hold a paged pack and run K1's wrapper
    (its plain version on the CPU).  Both give the oracle's answers."""
    rt = sres[1]
    lids, xs = _lanes(slists, rt.universe)
    want = _oracle(slists, lids, xs)
    for name, own in (("torch", "c"), ("cuda", "c_syms_pg")):
        eng = make_engine(name, rt, device="cpu", mesh=_mesh(n),
                          store="memory", page_size=128)
        for shard in eng._sharded_next_geq.shards:
            assert own in shard["tables"]
            assert shard["tables"][own].device == torch.device("cpu")
        np.testing.assert_array_equal(eng.next_geq_batch(lids, xs), want)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_one_shard_on_the_engine_device_shares_its_index(slists, sres,
                                                         engine, monkeypatch):
    """A shard that owns every list on the engine's device probes through
    the engine's own tables: no second copy of the index.  Out of core
    the engine's probe reads the pool, so the shard keeps its own copy
    of the stream."""
    rt = sres[1]
    lids, xs = _lanes(slists, rt.universe)
    cls = type(make_engine(engine, rt, device="cpu"))
    calls = []
    own = cls._next_geq_dev
    monkeypatch.setattr(cls, "_next_geq_dev",
                        lambda self, *a: calls.append(a) or own(self, *a))
    eng = make_engine(engine, rt, device="cpu", mesh=_mesh(1))
    assert eng._sharded_next_geq.shards[0]["tables"] == {}
    D.reset_dispatches()
    np.testing.assert_array_equal(eng.next_geq_batch(lids, xs),
                                  _oracle(slists, lids, xs))
    assert D.DISPATCHES["sharded_next_geq"] == 1 and len(calls) == 1
    stored = make_engine(engine, rt, device="cpu", mesh=_mesh(1),
                         store="memory", resident_pages=2, page_size=128)
    assert stored._sharded_next_geq.shards[0]["tables"]
    np.testing.assert_array_equal(stored.next_geq_batch(lids, xs),
                                  _oracle(slists, lids, xs))


def test_adversarial_lists_every_shard_count():
    lists = adversarial_lists(np.random.default_rng(SEED + 3),
                              universe=900, n_random=6, max_len=80)
    rt = repair_compress(lists)
    lids, xs = _lanes(lists, rt.universe)
    want = _oracle(lists, lids, xs)
    for n in (1, 2, 3, 4, len(lists) + 2):
        eng = make_engine("cuda", rt, device="cpu", mesh=_mesh(n),
                          page_size=128)
        np.testing.assert_array_equal(eng.next_geq_batch(lids, xs), want)
