"""The CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is False.
The file imports nothing of JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

* ``list_intersect`` (K1): routed lanes with every edge lane, at page 2048
  and at page 128 — kernel == plain version == set oracle;
* ``page_score`` (K2): every block-max directory entry plus count-0 pad
  rows — kernel == plain version == the lists' slices; and the tiled
  design's edges at page 128 and 2048 (a 20,000-slot entry beside
  entries of 1): counts on and beside 128- and 256-slot edges, count 0,
  empty windows with and without the head, a cut ``max_depth``, sums
  that wrap int32;
* ``ef_next_geq`` (K3): edge lanes (absent lists, heads, tails, past the
  tail, negative probes, every bucket boundary) and a random batch over an
  EF store with ``l == 0`` lists and word-straddling fields; every probe
  of dense and clustered lists (selects at word and sample-page
  boundaries, ``hx - 1`` and ``hx`` in different pages), ``l = 30`` and
  ``l = 31`` lists at ``INT_MIN`` and ``INT_INF``, and a pack whose
  high-bits words are an unaligned view — kernel == plain version ==
  numpy reference == set oracle;
* ``CudaEngine`` on the card == ``CudaEngine`` on the CPU for probes,
  intersections (short sides longer than one probe row among them) and
  ranked top-k, with every launch counted — and the same under the codec
  tiers ``ef``, ``bitmap`` and ``adaptive``;
* K1's resident route (out of core) on a pool smaller than the stream,
  its rows outside the working set poisoned, at pages 128, 384 and 2048
  — kernel == plain version == fully resident route == set oracle; a
  ``CudaEngine(store="mmap")`` at a ~10% budget on the card == on the CPU
  == fully resident; the pool's device mirror re-uploaded whole after a
  grow;
* ``pair_count`` (K4): random streams with tables of one and of several
  shared-memory chunks (duplicates straddling a chunk boundary),
  sentinels, negative symbols, all-invalid, one-slot and empty streams —
  kernel == plain version == numpy oracle; and the hash-table design's
  edges: keys crowding a few home slots, one pair over a whole
  954,112-slot stream, K = 1, 8,192 and 32,768, streams of every length
  mod 4 (and N = 0) aligned and not, shuffled sentinels and duplicates;
* ``CudaBuilder`` and ``TorchBuilder`` on the card == ``HostBuilder``,
  with one K4 launch per round, and ``QueryServer.rebuild`` on the card
  serving the rebuilt index exactly;
* ``gap_decode`` (K6): aligned and unaligned rows, ``firsts`` as (R,) and
  (R, 1), sums that wrap — kernel == plain version == numpy;
* ``bitmap_and`` (K8): sizes with and without a scalar tail, unaligned
  operands, all-ones words — AND and total == plain version == numpy;
* ``bucket_intersect`` (K7): unsorted rows with duplicates and interior
  ``INT_INF``, CAPs on both sides of the warp / block split, bucketized
  lists; and the hash-set design's edges: a row of b entered in chunks,
  values sharing a home slot, all-``INT_INF`` rows, CAP not a multiple
  of 4, negative values, heavy duplicates — kernel == plain version ==
  set oracle;
* ``grammar_expand`` (K5): every symbol of a real grammar at full and cut
  ``max_depth``, terminals only, padded ids — kernel == plain version ==
  the host stack walk; and the slot-dealing design's edges: hand-made
  tables with lens that disagree with the children's (wants that wrap),
  phrases of 33-64 gaps, a cut at every depth, ids -1, S and S + 5, W no
  multiple of a block's 32 rows; the smoke's shapes (373,111, 100,003 at
  half depth and 1,037 symbols) over a real grammar;
* K1's one-shot surface (``next_geq``, ``next_geq_probe``,
  ``list_intersect`` of an index) on the card == with ``device="cpu"``;
* list-sharded serving: ``QueryServer(mesh=...)`` on ``[cuda:0]`` and
  ``[cuda:0, cuda:0]`` == ``device="cpu"``, the sharded dispatch counted,
  K1 and K2 still launched;
* streaming ingestion: interleaved insert and search through a
  ``QueryServer(engine="cuda")`` on the card, flushed and compacted by the
  cuda builder (K4), a segment of one document among them (an empty
  stream) — every answer == the rebuild-from-scratch oracle, and K1 and
  K2 launched by the segment engines;
* the LM tier: each of the five LM archs' smoke configs served by
  ``DecodeEngine`` on the card against the same parameters with
  ``device="cpu"``, teacher-forced on the CPU run's tokens (same inputs at
  every prefill and step, logits within 2e-2, the same finished
  requests), and on the card ``prefill`` == ``forward`` at the last
  position;
* training: ``matmul_f32``'s gradient on the card (the logits' float32
  product, through its ``autograd.Function``) against the CPU's, and one
  train step of each LM smoke arch on the card against the CPU;
* distribution, on meshes of repeated ``cuda:0`` entries against the same
  meshes of CPU entries: ``moe_ffn_sharded`` in each placement (TP inside,
  expert parallel, padded, two data shards; 2e-2), the granite smoke LM
  with the mesh wired in (2e-2), ``compressed_psum_with_feedback`` bit for
  bit over 2 and 3 shards, and ``pipeline_apply`` forward and gradients
  (and against ``mlp_reference`` on the card, 1e-5 / 1e-4);
* the dry run against the card: a train step and a decode tick of the
  yi-6b and granite smoke configs on a (1, 1) mesh of ``cuda:0`` —
  ``FlopCounterMode``'s count of the card's run equals the meta trace's
  FLOPs, and the real arguments' bytes the spec's; and
  ``CheckpointManager.restore(shardings=)`` onto (2, 2) and (1, 4) meshes
  of repeated ``cuda:0``, each shard on the card and equal to
  ``shard_tensor`` of the saved tensor bit for bit.
"""

import numpy as np
import pytest
import torch

from strategies import adversarial_lists

from repro_torch import kernels as KR
from repro_torch.core import ef as EF
from repro_torch.core import index as TI
from repro_torch.core.repair import repair_compress
from repro_torch.engine import CudaEngine
from repro_torch.kernels.bitmap_and import ops as K8
from repro_torch.kernels.bucket_intersect import ops as K7
from repro_torch.kernels.ef_next_geq import ops as K3
from repro_torch.kernels.gap_decode import ops as K6
from repro_torch.kernels.grammar_expand import ops as K5
from repro_torch.kernels.list_intersect import ops as K1
from repro_torch.kernels.page_score import ops as K2
from repro_torch.kernels.pair_count import ops as K4
from repro_torch.kernels.pair_count import pair_count_ref
from repro_torch.query import naive_eval, parse, search_topk
from repro_torch.serve.scheduler import QueryScheduler
from repro_torch.store import ResidentSet, build_page_store

pytestmark = pytest.mark.cuda
INF = int(TI.INT_INF)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return KR.resolve_device("cuda")


@pytest.fixture(scope="module")
def clists():
    """Random lists, dense runs (deep phrases, skip windows straddling
    128-symbol pages), a long incompressible list and the adversarial
    shapes (a singleton among them)."""
    rng = np.random.default_rng(11)
    big = np.unique(rng.choice(20_000, size=1500, replace=False))
    return ([np.unique(rng.choice(20_000, size=int(rng.integers(20, 400)),
                                  replace=False)) for _ in range(12)]
            + [np.arange(0, 2400, dtype=np.int64),
               np.arange(5000, 9000, 3, dtype=np.int64), big, big[:40]]
            + adversarial_lists(np.random.default_rng(5), universe=20_000))


@pytest.fixture(scope="module")
def cres(clists):
    return repair_compress(clists)


def _lanes(lists, universe, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    lids = list(rng.integers(0, len(lists), n))
    xs = list(rng.integers(0, universe + 50, n))
    for t, arr in enumerate(lists):
        for x in (0, arr[0], arr[0] + 1, arr[len(arr) // 2], arr[-1],
                  arr[-1] + 1, universe + 5):
            lids.append(t)
            xs.append(int(x))
    return np.asarray(lids, np.int32), np.asarray(xs, np.int32)


def _oracle(lists, lids, xs):
    out = []
    for t, x in zip(lids.tolist(), xs.tolist()):
        p = int(np.searchsorted(lists[t], x))
        out.append(int(lists[t][p]) if p < len(lists[t]) else INF)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("page", [2048, 128])
def test_list_intersect_kernel_matches_plain(card, clists, cres, page):
    pt = TI.build_paged_index(TI.build_flat_index(cres, device=card), page)
    tables, statics, host = K1.pad_paged_operands(pt)
    lids, xs = _lanes(clists, cres.universe)
    order, *lanes = K1.route_pages(host, lids, xs)
    lanes = [torch.from_numpy(a).to(card) for a in lanes]
    n0 = KR.LAUNCHES["list_intersect"]
    got = K1.paged_intersect(*lanes, tables, **statics)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["list_intersect"] == n0 + 1
    plain = K1.paged_intersect_plain(*lanes, tables, **statics)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(clists, lids[order], xs[order]))


@pytest.mark.parametrize("page", [2048, 128])
def test_page_score_kernel_matches_plain(card, clists, cres, page):
    pt = TI.build_paged_index(TI.build_flat_index(cres, device=card), page)
    si = TI.build_score_index(cres, page_size=page)
    e = np.concatenate([np.arange(si.pg_list.size), [0, 1]])
    pages = si.pg_page[e].astype(np.int64)
    cnt = si.pg_count[e].copy()
    cnt[-2:] = 0                                   # pad rows
    meta = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(card)
            for a in (pages, si.pg_sym_lo[e] - pages * page,
                      si.pg_sym_hi[e] - si.pg_sym_lo[e], si.pg_base[e],
                      si.pg_head[e], cnt)]
    tables, statics = K2.pad_score_operands(pt)
    b_pad = max(128, 1 << (int(si.max_page_elems) - 1).bit_length())
    n0 = KR.LAUNCHES["page_score"]
    got = K2.page_score(*meta, tables, b_pad=b_pad, **statics)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["page_score"] == n0 + 1
    assert torch.equal(got, K2.page_score_plain(*meta, tables, b_pad=b_pad,
                                                **statics))
    rows = got.cpu().numpy()
    assert (rows[-2:] == INF).all()
    for q, ei in enumerate(e[:-2].tolist()):
        lo, c = int(si.pg_elem_lo[ei]), int(si.pg_count[ei])
        np.testing.assert_array_equal(rows[q, :c],
                                      clists[int(si.pg_list[ei])][lo:lo + c])
        assert (rows[q, c:] == INF).all()


def test_cuda_engine_on_card_matches_cpu(card, clists, cres):
    on_card = CudaEngine(cres, page_size=128, device=card)
    on_cpu = CudaEngine(cres, page_size=128, device="cpu")
    lids, xs = _lanes(clists, cres.universe, n=500)
    n0 = dict(KR.LAUNCHES)
    np.testing.assert_array_equal(on_card.next_geq_batch(lids, xs),
                                  on_cpu.next_geq_batch(lids, xs))
    pairs = [(0, 12), (13, 2), (15, 16), (3, 14), (12, 13), (14, 12)]
    for g, w in zip(on_card.intersect_pairs(pairs),
                    on_cpu.intersect_pairs(pairs)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(on_card.intersect_multi([12, 13, 14]),
                                  on_cpu.intersect_multi([12, 13, 14]))
    for bag in ([15, 16], [0, 12, 13]):
        g, w = search_topk(on_card, bag, 10), search_topk(on_cpu, bag, 10)
        np.testing.assert_array_equal(g.docs, w.docs)
        np.testing.assert_array_equal(g.scores, w.scores)
    assert KR.LAUNCHES["list_intersect"] > n0["list_intersect"]
    assert KR.LAUNCHES["page_score"] > n0["page_score"]


@pytest.mark.parametrize("shards_n", [1, 2])
def test_sharded_engine_on_card_matches_cpu(card, clists, cres, shards_n):
    """List-sharded serving on the card: a mesh of ``[cuda:0]`` and of
    ``[cuda:0, cuda:0]`` gives the answers of ``device="cpu"``; the
    merged rounds take the sharded dispatch, K1 on every shard,
    ``_probe_dev`` still launches K1 and the ranked decodes K2.  A CPU
    mesh under a card engine raises."""
    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    from repro_torch.serve import QueryServer
    mesh = Mesh([card] * shards_n)
    srv = QueryServer(cres, engine="cuda", device=card, mesh=mesh,
                      batch_window=8)
    cpu = QueryServer(cres, engine="cuda", device="cpu", batch_window=8)
    shards = srv.engine._sharded_next_geq.shards
    assert all(t.device == card for s in shards
               for t in s["tables"].values())
    assert all("c_syms_pg" in s["tables"] for s in shards) == (shards_n > 1)
    lids, xs = _lanes(clists, cres.universe, n=500)
    n0 = dict(KR.LAUNCHES)
    D.reset_dispatches()
    np.testing.assert_array_equal(srv.next_geq_batch(lids, xs),
                                  cpu.next_geq_batch(lids, xs))
    # the sharded round probes every shard with K1
    assert KR.LAUNCHES["list_intersect"] - n0["list_intersect"] == len(shards)
    qs = ["0 AND 12", "(13 AND 2) OR NOT 15", "12 AND 13 AND 14",
          "3 AND NOT 14"]
    for algo in (None, "svs"):
        for g, w in zip(srv.search_many(qs, algo), cpu.search_many(qs, algo)):
            np.testing.assert_array_equal(g, w)
    pairs = [(0, 12), (13, 2), (15, 16), (3, 14)]
    for g, w in zip(srv.and_batch(pairs), cpu.and_batch(pairs)):
        np.testing.assert_array_equal(g, w)
    for bag in ([15, 16], [0, 12, 13]):
        g, w = srv.search_topk(bag, 10), cpu.search_topk(bag, 10)
        np.testing.assert_array_equal(g.docs, w.docs)
        np.testing.assert_array_equal(g.scores, w.scores)
    assert D.DISPATCHES["sharded_next_geq"] > 0
    assert KR.LAUNCHES["list_intersect"] > n0["list_intersect"]
    assert KR.LAUNCHES["page_score"] > n0["page_score"]
    with pytest.raises(ValueError, match="not a device of the mesh"):
        QueryServer(cres, engine="cuda", device=card,
                    mesh=Mesh(["cpu"]))


@pytest.fixture(scope="module")
def rlists():
    """Enough random lists (and two dense runs) for a stream of over ten
    2,048-symbol pages, so a pool smaller than the stream exists at every
    page size."""
    rng = np.random.default_rng(23)
    return ([np.unique(rng.choice(60_000, size=int(rng.integers(20, 500)),
                                  replace=False)) for _ in range(160)]
            + [np.arange(0, 3000, dtype=np.int64),
               np.arange(7000, 19000, 4, dtype=np.int64)])


@pytest.fixture(scope="module")
def rres(rlists):
    return repair_compress(rlists)


@pytest.mark.parametrize("page", [128, 384, 2048])
def test_list_intersect_resident_matches_plain(card, rlists, rres, page):
    """K1's resident route on a pool smaller than the stream, its rows
    outside the working set poisoned (row 0, where absent pages clamp,
    among them), with lanes that need no stream read on lists outside the
    working set: kernel == plain version == the fully resident route ==
    set oracle, in one launch."""
    pt = TI.build_paged_index(TI.build_flat_index(rres, device=card), page)
    tables, statics, host = K1.pad_paged_operands(pt, include_stream=False)
    full = K1.pad_paged_operands(pt)[0]
    starts = np.asarray(rres.starts)
    half = pt.num_pages // 2
    pick = np.flatnonzero(starts[1:] <= half * page)
    lids, xs = _lanes([rlists[t] for t in pick], 60_000, n=6000)
    lids = pick[lids].astype(np.int32)
    # lanes that need no stream read, on lists outside the working set:
    # their start pages read as poison
    settled = np.flatnonzero(starts[:-1] >= (half + 1) * page)
    lids = np.concatenate([lids, np.repeat(settled, 3)]).astype(np.int32)
    xs = np.concatenate([xs, [x for t in settled for x in (
        0, rlists[t][0], rlists[t][-1] + 1)]]).astype(np.int32)
    ws = K1.probe_working_set(host, lids, xs)
    assert not np.isin(starts[settled] // page, ws).any()
    others = np.setdiff1d(np.arange(pt.num_pages), ws)[:3]
    assert ws.size and ws.size + others.size < pt.num_pages
    rs = ResidentSet(build_page_store(rres, kind="memory", pi=pt),
                     budget=ws.size + others.size)
    rs.ensure(others)
    rs.ensure(ws)
    assert rs.slot_of_page[others[0]] == 0
    syms, sums, slots = rs.device_tables(card)
    assert syms.device == card and syms.shape == (ws.size + 3, page)
    assert K1.poison_outside(syms, sums, slots, ws, seed=page) == 3
    order, *lanes = K1.route_pages(host, lids, xs)
    lanes = [torch.from_numpy(a).to(card) for a in lanes]
    pool = dict(tables, c_syms_pg=syms, c_sums_pg=sums)
    n0 = KR.LAUNCHES["list_intersect"]
    got = K1.paged_intersect(*lanes, pool, slot_of_page=slots, **statics)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["list_intersect"] == n0 + 1
    plain = K1.paged_intersect_plain(*lanes, pool, slot_of_page=slots,
                                     **statics)
    assert torch.equal(got, plain)
    assert torch.equal(got, K1.paged_intersect(*lanes, full, **statics))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(rlists, lids[order], xs[order]))


def test_cuda_engine_store_on_card_matches_cpu(card, rlists, rres):
    """``CudaEngine(store="mmap")`` at a ~10% budget on the card == the
    same engine on the CPU == the engine fully resident: probes,
    intersections, coalesced boolean queries and ranked top-k, with K1's
    resident route launched."""
    budget = max(1, -(-int(np.asarray(rres.starts)[-1]) // 128) // 10)
    kw = dict(page_size=128, store="mmap", resident_pages=budget)
    on_card = CudaEngine(rres, device=card, **kw)
    on_cpu = CudaEngine(rres, device="cpu", **kw)
    resident = CudaEngine(rres, device=card, page_size=128, store="")
    assert on_card.pi.c_syms_pg.shape[0] == 1 and on_card.fi.c.numel() == 1
    lids, xs = _lanes(rlists, 60_000, n=3000)
    n0 = dict(KR.LAUNCHES)
    want = resident.next_geq_batch(lids, xs)
    for eng in (on_card, on_cpu):
        np.testing.assert_array_equal(eng.next_geq_batch(lids, xs), want)
    assert KR.LAUNCHES["list_intersect"] >= n0["list_intersect"] + 2
    pairs = [(0, 12), (13, 2), (160, 161), (3, 14), (161, 40), (7, 160)]
    for g, w, r in zip(on_card.intersect_pairs(pairs),
                       on_cpu.intersect_pairs(pairs),
                       resident.intersect_pairs(pairs)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    qs = [f"{a} AND {b}" for a, b in pairs] + ["(0 AND 160) OR NOT 161"]
    got = QueryScheduler(on_card, batch_window=8).search_many(qs)
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(
            g, naive_eval(parse(q), rlists, rres.universe))
    for bag in ([160, 161], [0, 12, 13]):
        g, w = search_topk(on_card, bag, 10), search_topk(on_cpu, bag, 10)
        np.testing.assert_array_equal(g.docs, w.docs)
        np.testing.assert_array_equal(g.scores, w.scores)
    assert on_card.resident.stats()["page_faults"] > 0


def test_resident_pool_grow_reuploads_whole(card, rres):
    """The device mirror: fault batches land by ``index_copy_`` in the
    same card tensors; after a ``_grow`` the whole pool is uploaded again
    at its new shape.  The mirror always equals the numpy pool."""
    rs = ResidentSet(build_page_store(rres, kind="memory", page_size=128),
                     budget=3)
    rs.ensure([0, 1])
    syms, sums, slots = rs.device_tables(card)
    rs.ensure([5])
    again = rs.device_tables(card)
    assert again[0] is syms and again[1] is sums
    rs.ensure(np.arange(6, 11))                  # 5 pages > budget 3
    assert rs.pool_grows == 1 and rs.budget == 6
    grown = rs.device_tables(card)
    assert grown[0] is not syms and grown[0].shape == (6, 128)
    assert grown[0].device == card
    for t, a in zip(grown, (rs.pool_syms, rs.pool_sums, rs.slot_of_page)):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_resident_mirror_orders_overlapping_batches(card, rlists, rres):
    """Two pending fault batches that write the same pool row on the
    card: a prefetch admission, then a demand ``ensure`` that evicts the
    prefetched pages into those rows, both before the next
    ``device_tables``.  The mirror equals the numpy pool, and K1's
    resident route answers exactly."""
    lids = np.repeat(np.array([3, 40, 90, 161], np.int32), 64)
    xs = np.random.default_rng(5).integers(
        0, 60_000, lids.size).astype(np.int32)
    full = CudaEngine(rres, device=card, page_size=128, store="")
    n = K1.probe_working_set(full._host, lids, xs).size
    assert n >= 2
    eng = CudaEngine(rres, device=card, page_size=128, store="memory",
                     resident_pages=n)
    rs = eng.resident
    ws = K1.probe_working_set(eng._route_host, lids, xs)
    rest = np.setdiff1d(np.arange(rs.store.num_pages), ws)
    old, pf = rest[:n], rest[n:n + n // 2]
    rs.ensure(old)
    rs.device_tables(card)
    assert rs.admit_prefetched(pf, *rs.store.gather(pf)) == pf.size
    pf_rows = rs.slot_of_page[pf].copy()
    rs.ensure(ws)                       # evicts the rest of old, then pf
    assert (rs.slot_of_page[pf] < 0).all()
    assert np.isin(pf_rows, rs.slot_of_page[ws]).all()
    faults, n0 = rs.page_faults, KR.LAUNCHES["list_intersect"]
    got = eng.next_geq_batch(lids, xs)
    assert KR.LAUNCHES["list_intersect"] > n0
    assert rs.page_faults == faults and rs.pool_grows == 0
    np.testing.assert_array_equal(got, full.next_geq_batch(lids, xs))
    np.testing.assert_array_equal(got, _oracle(rlists, lids, xs))
    for t, a in zip(rs.device_tables(card),
                    (rs.pool_syms, rs.pool_sums, rs.slot_of_page)):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_ef_next_geq_kernel_matches_plain(card, clists):
    rng = np.random.default_rng(17)
    u = 2**31 - 1
    lists = (list(clists) + [None, np.arange(0, 700), np.arange(3, 900, 2)]
             + [np.unique(rng.integers(0, u, int(rng.integers(2, 60))))
                for _ in range(8)] + [np.asarray([2**30 + 9])])
    store = EF.build_ef_store(lists, u)
    rank = store.select_samples()
    pack = K3.pad_ef_operands(store, rank, card)
    lids, xs = [], []
    for t, v in enumerate(lists):
        cand = [0, -1, -2**31, 2**31 - 1, 20_005]
        if v is not None:
            v = np.asarray(v, np.int64)
            l = EF._list_lbits(v.size, int(v[-1]))
            h = np.unique(v >> l)
            cand += [*v[:50], *(v[:50] + 1), *(v[:50] - 1), v[-1], v[-1] + 1,
                     *(h << l), *(((h + 1) << l) - 1)]
        lids += [t] * len(cand)
        xs += cand
    lids = np.concatenate([lids, rng.integers(0, len(lists), 20_000)])
    xs = np.concatenate([xs, rng.integers(-5, 20_100, 20_000)])
    xs = np.clip(xs, -2**31, 2**31 - 1).astype(np.int32)
    lids = lids.astype(np.int32)
    lt, xt = torch.from_numpy(lids).to(card), torch.from_numpy(xs).to(card)
    n0 = KR.LAUNCHES["ef_next_geq"]
    got = K3.ef_next_geq(lt, xt, pack)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["ef_next_geq"] == n0 + 1
    assert torch.equal(got, K3.ef_next_geq_plain(lt, xt, pack))
    want = EF.ef_next_geq_np(store, rank, lids, xs)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    live = np.asarray([lists[t] is not None for t in lids.tolist()])
    np.testing.assert_array_equal(
        want[live], _oracle([v if v is not None else np.zeros(0, np.int64)
                             for v in lists], lids[live], xs[live]))


@pytest.mark.parametrize("codec", ["ef", "bitmap", "adaptive"])
def test_cuda_engine_codec_on_card_matches_cpu(card, clists, cres, codec):
    on_card = CudaEngine(cres, device=card, codec=codec)
    on_cpu = CudaEngine(cres, device="cpu", codec=codec)
    assert np.array_equal(on_card.tier.codec, on_cpu.tier.codec)
    lids, xs = _lanes(clists, cres.universe, n=3000)
    n0 = dict(KR.LAUNCHES)
    np.testing.assert_array_equal(on_card.next_geq_batch(lids, xs),
                                  on_cpu.next_geq_batch(lids, xs))
    np.testing.assert_array_equal(on_card.member_batch(lids, xs),
                                  on_cpu.member_batch(lids, xs))
    for algo in ("svs", "bys"):
        np.testing.assert_array_equal(
            on_card.dispatch_round(lids[:777], xs[:777], algo),
            on_cpu.dispatch_round(lids[:777], xs[:777], algo))
    assert on_card.lane_stats == on_cpu.lane_stats
    assert on_card.codec_dispatches == on_cpu.codec_dispatches
    pairs = [(0, 12), (13, 2), (15, 16), (3, 14), (12, 13), (14, 12)]
    for g, w in zip(on_card.intersect_pairs(pairs),
                    on_cpu.intersect_pairs(pairs)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(on_card.intersect_multi([12, 13, 14]),
                                  on_cpu.intersect_multi([12, 13, 14]))
    for bag in ([15, 16], [0, 12, 13]):
        g, w = search_topk(on_card, bag, 10), search_topk(on_cpu, bag, 10)
        np.testing.assert_array_equal(g.docs, w.docs)
        np.testing.assert_array_equal(g.scores, w.scores)
    if on_card.tier.ef is not None:
        assert KR.LAUNCHES["ef_next_geq"] > n0["ef_next_geq"]
    assert KR.LAUNCHES["page_score"] > n0["page_score"]


@pytest.mark.parametrize("K, n, alphabet", [
    (4096, 300_000, 90), (9000, 50_000, 5), (37, 1, 5), (128, 0, 5),
    (600, 5000, 3)])
def test_pair_count_kernel_matches_plain(card, K, n, alphabet):
    """One chunk (K = 4096); three chunks whose runs of equal keys (about
    300 copies of each of 30 keys) straddle the chunk boundaries
    (K = 9000); tiny and empty streams; a hot alphabet; -1 sentinels."""
    rng = np.random.default_rng(K + n)
    seq = rng.integers(0, alphabet, n + 1).astype(np.int32)
    seq[:3] = -1                       # negative symbols in valid slots
    active = rng.random(n + 1) < 0.9
    ca = rng.integers(-1, alphabet, K).astype(np.int32)
    cb = rng.integers(0, alphabet, K).astype(np.int32)
    args = [torch.from_numpy(a).to(card) for a in (ca, cb)]
    stream = K4.pair_stream(torch.from_numpy(seq).to(card),
                            torch.from_numpy(active).to(card), n + 1)
    n0 = KR.LAUNCHES["pair_count"]
    got = K4.pair_count(*args, *stream)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["pair_count"] == n0 + 1
    assert torch.equal(got, K4.pair_count_plain(*args, *stream))
    np.testing.assert_array_equal(
        got.cpu().numpy(), pair_count_ref(seq, active, n + 1, ca, cb))
    none = torch.zeros_like(stream[2])             # all slots invalid
    assert not K4.pair_count(*args, stream[0], stream[1], none).any()


@pytest.fixture(scope="module")
def zipf_lists():
    from repro_torch.index.corpus import zipf_corpus
    return zipf_corpus(num_docs=2000, vocab_size=2000, mean_doc_len=120,
                       seed=3).postings()


def test_builders_on_card_match_host(card, zipf_lists):
    from repro_torch.build import make_builder
    cfg = dict(table_cap=4096, pairs_per_round=64)
    host = make_builder("host", **cfg).build_grammar(zipf_lists)
    for name in ("torch", "cuda"):
        bld = make_builder(name, device=card, **cfg)
        n0 = KR.LAUNCHES["pair_count"]
        res = bld.build_grammar(zipf_lists)
        launched = KR.LAUNCHES["pair_count"] - n0
        assert launched == (bld.stats["rounds"] if name == "cuda" else 0)
        for a, b in ((host.grammar.rules, res.grammar.rules),
                     (host.grammar.sums, res.grammar.sums),
                     (host.grammar.lengths, res.grammar.lengths),
                     (host.grammar.depths, res.grammar.depths),
                     (host.seq, res.seq), (host.starts, res.starts)):
            np.testing.assert_array_equal(a, b)
    for i in range(0, len(zipf_lists), 97):
        np.testing.assert_array_equal(res.decode_list(i), zipf_lists[i])


def test_rebuild_on_card(card, zipf_lists, cres):
    from repro_torch.build import BuildConfig
    from repro_torch.serve import QueryServer
    srv = QueryServer(cres, engine="cuda", device=card)
    n0 = KR.LAUNCHES["pair_count"]
    res = srv.rebuild(zipf_lists, builder="cuda",
                      build_cfg=BuildConfig(table_cap=4096))
    assert KR.LAUNCHES["pair_count"] > n0
    assert srv.version == 1 and srv.engine.device == card
    n0 = dict(KR.LAUNCHES)
    qs = ["0 AND 1", "(2 AND 3) OR 4", "5 AND NOT 6", "7 AND 8 AND 9",
          "1500 AND 1600", "1700 AND 3"]
    for q, got in zip(qs, srv.search_many(qs)):
        np.testing.assert_array_equal(
            got, naive_eval(srv.plan(q).node, zipf_lists, res.universe))
    lids, xs = _lanes(zipf_lists, res.universe, n=2000)
    np.testing.assert_array_equal(srv.next_geq_batch(lids, xs),
                                  _oracle(zipf_lists, lids, xs))
    g = srv.search_topk([3, 1500], 10)
    w = search_topk(CudaEngine(res, device="cpu"), [3, 1500], 10)
    np.testing.assert_array_equal(g.docs, w.docs)
    np.testing.assert_array_equal(g.scores, w.scores)
    assert KR.LAUNCHES["list_intersect"] > n0["list_intersect"]
    assert KR.LAUNCHES["page_score"] > n0["page_score"]


def test_interleaved_ingest_on_card(card):
    """Streaming ingestion on the card: every answer of every step equals
    the oracle over the current corpus; flushes and compactions build on
    the card (K4); the segment engines are cuda engines on the card and
    launch K1 and K2 themselves."""
    from repro_torch.build import make_builder
    from repro_torch.data import PostingsSource
    from repro_torch.query import rank_oracle
    from repro_torch.query.ast import And, Not, Or, Term
    from repro_torch.serve import QueryServer
    vocab = 64
    src = PostingsSource(base_docs=16, growth_docs=8, vocab=vocab,
                         mean_doc_len=12, seed=17)
    docs = [np.arange(vocab, dtype=np.int64)] + [src.doc_terms(d)
                                                  for d in range(63)]

    def invert(ds):
        inv = {}
        for d, terms in enumerate(ds):
            for t in terms.tolist():
                inv.setdefault(int(t), []).append(d)
        return [np.asarray(inv[t], np.int64) for t in sorted(inv)]

    srv = QueryServer(repair_compress(invert(docs[:24])), max_short_len=64,
                      engine="cuda", device=card)
    seg = srv.enable_ingest(delta_budget=6, compact_fanout=2,
                            builder=make_builder("cuda", device=card,
                                                 table_cap=4096))
    k4 = KR.LAUNCHES["pair_count"]
    srv.insert(docs[24])
    assert srv.flush().res.seq.size == 0        # one document: no stream
    rng = np.random.default_rng(1)
    for i, d in enumerate(docs[25:]):
        srv.insert(d)
        lists, n = invert(docs[:26 + i]), 26 + i
        a, b, c = (int(t) for t in rng.choice(vocab, 3, replace=False))
        qs = [And((Term(a), Term(b))), Or((Term(a), Not(Term(c))))]
        for q, got in zip(qs, srv.search_many(qs)):
            np.testing.assert_array_equal(got, naive_eval(q, lists, n))
        ts = sorted(int(t) for t in rng.choice(vocab, 4, replace=False))
        rr = srv.search_topk(ts, 10)
        od, osc = rank_oracle(lists, n, ts, 10)
        np.testing.assert_array_equal(rr.docs, od)
        np.testing.assert_array_equal(rr.scores, osc)
    t = seg.telemetry()
    assert t["flushes"] >= 5 and t["compactions"] >= 1, t
    assert KR.LAUNCHES["pair_count"] > k4
    # the segment engines' own launches
    by_segments = dict.fromkeys(("list_intersect", "page_score"), 0)

    def counted(fn, name):
        def run(*a, **kw):
            n0 = KR.LAUNCHES[name]
            out = fn(*a, **kw)
            by_segments[name] += KR.LAUNCHES[name] - n0
            return out
        return run
    for s in seg.segments[1:]:
        assert isinstance(s.engine, CudaEngine) and s.engine.device == card
        s.engine._next_geq_dev = counted(s.engine._next_geq_dev,
                                         "list_intersect")
        s.engine.decode_page_batch = counted(s.engine.decode_page_batch,
                                             "page_score")
    lists, n = invert(docs), len(docs)
    qs = [And((Term(0), Term(int(t)))) for t in range(1, 9)]
    for q, got in zip(qs, srv.search_many(qs, force_algo="svs")):
        np.testing.assert_array_equal(got, naive_eval(q, lists, n))
    rr = srv.search_topk([0, 1, 2, 3], 10)
    od, osc = rank_oracle(lists, n, [0, 1, 2, 3], 10)
    np.testing.assert_array_equal(rr.docs, od)
    np.testing.assert_array_equal(rr.scores, osc)
    assert by_segments["list_intersect"] > 0, by_segments
    assert by_segments["page_score"] > 0, by_segments


def _counted(name, fn, *args, **kw):
    """Run a wrapper on card tensors; it must launch its kernel once."""
    n0 = KR.LAUNCHES[name]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert KR.LAUNCHES[name] == n0 + 1
    return out


@pytest.mark.parametrize("R, C", [(1, 7), (3, 130), (5, 701), (64, 4096),
                                  (300, 4097)])
@pytest.mark.parametrize("firsts_2d", [False, True])
def test_gap_decode_kernel_matches_plain(card, R, C, firsts_2d):
    """Rows of C % 4 != 0 alternate between the vector and the scalar
    path; row 1 wraps past 2**31 - 1."""
    rng = np.random.default_rng(R * C)
    gaps = rng.integers(0, 3000, (R, C)).astype(np.int32)
    firsts = rng.integers(0, 1000, R).astype(np.int32)
    if R > 1:
        gaps[1] = rng.integers(2**28, 2**30, C)
    if firsts_2d:
        firsts = firsts[:, None].copy()
    g, f = (torch.from_numpy(a).to(card) for a in (gaps, firsts))
    got = _counted("gap_decode", K6.gap_decode, g, f)
    assert torch.equal(got, K6.gap_decode_plain(g, f))
    want = (np.cumsum(gaps.astype(np.int64), 1) + firsts.reshape(-1, 1)
            ).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("n, offset", [(1, 0), (3, 0), (4, 0), (5000, 0),
                                       (1 << 20, 0), ((1 << 20) + 3, 1)])
def test_bitmap_and_kernel_matches_plain(card, n, offset):
    """``offset`` 1 starts both operands 4 bytes into their buffers: the
    kernel must take its scalar path."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**32, n + offset, dtype=np.uint32)
    b = rng.integers(0, 2**32, n + offset, dtype=np.uint32)
    a[offset:offset + 64] = 0xFFFFFFFF
    ta, tb = (torch.from_numpy(x).to(card)[offset:] for x in (a, b))
    a, b = a[offset:], b[offset:]
    w = _counted("bitmap_and", K8.bitmap_and, ta, tb)
    w2, total = _counted("bitmap_and", K8.bitmap_and_count, ta, tb)
    pw, ptotal = K8.bitmap_and_count_plain(ta, tb)
    for x in (w, w2, pw):
        assert x.dtype == torch.uint32
        np.testing.assert_array_equal(x.cpu().numpy(), a & b)
    assert total.dtype == torch.int32 and total.shape == ()
    assert int(total) == int(ptotal) == int(
        np.unpackbits((a & b).view(np.uint8)).sum())


@pytest.mark.parametrize("nb, cap", [(5, 37), (3, 1500), (9, 130), (1, 1)])
def test_bucket_intersect_kernel_matches_plain(card, nb, cap):
    rng = np.random.default_rng(nb * cap)
    hi = max(4, cap // 3)
    a = rng.integers(0, hi, (nb, cap)).astype(np.int32)
    b = rng.integers(0, hi, (nb, cap)).astype(np.int32)
    a[rng.random((nb, cap)) < 0.1] = INF
    b[rng.random((nb, cap)) < 0.1] = INF
    ta, tb = (torch.from_numpy(x).to(card) for x in (a, b))
    got = _counted("bucket_intersect", K7.bucket_intersect, ta, tb)
    assert torch.equal(got, K7.bucket_intersect_plain(ta, tb))
    for r in range(nb):
        hit = (a[r] != INF) & np.isin(a[r], b[r])
        np.testing.assert_array_equal(got[r].cpu().numpy(),
                                      np.where(hit, a[r], INF))


def test_bucket_intersect_kernel_bucketized_lists(card):
    rng = np.random.default_rng(17)
    u = 20000
    x = np.sort(rng.choice(u, 4000, replace=False))
    y = np.sort(rng.choice(u, 6000, replace=False))
    ta, tb = (torch.from_numpy(K7.bucketize(v, u, 7, 128)).to(card)
              for v in (x, y))
    got = _counted("bucket_intersect", K7.bucket_intersect, ta, tb)
    assert torch.equal(got, K7.bucket_intersect_plain(ta, tb))
    np.testing.assert_array_equal(K7.unbucketize(got.cpu().numpy()),
                                  np.intersect1d(x, y))


def _stack_walk(s, left, right, sums):
    stack, out = [int(s)], []
    while stack:
        t = stack.pop()
        if left[t] < 0:
            out.append(int(sums[t]))
        else:
            stack += [int(right[t]), int(left[t])]
    return out


@pytest.mark.parametrize("cut", [None, 0, 1, "half"])
def test_grammar_expand_kernel_matches_plain(card, cres, cut):
    fi = TI.build_flat_index(cres, device=card)
    tabs = [fi.sym_left, fi.sym_right, fi.sym_sum, fi.sym_len]
    depth = {None: fi.max_depth, "half": fi.max_depth // 2}.get(cut, cut)
    S = int(fi.sym_len.numel())
    syms = torch.cat([torch.arange(S, dtype=torch.int32, device=card),
                      torch.tensor([S, S + 5, -1], dtype=torch.int32,
                                   device=card)])
    got = _counted("grammar_expand", K5.grammar_expand, syms, *tabs,
                   max_depth=depth)
    assert torch.equal(got, K5.grammar_expand_plain(syms, *tabs,
                                                    max_depth=depth))
    assert not got[S:].any()                    # padded ids: zero rows
    if cut is None:
        left, right, sums, lens = (t.cpu().numpy() for t in tabs)
        rows = got.cpu().numpy()
        for s in np.nonzero(lens <= K5.PHRASE_CAP)[0][::7]:
            want = _stack_walk(s, left, right, sums)
            np.testing.assert_array_equal(rows[s, :len(want)], want)
            assert not rows[s, len(want):].any()


def test_grammar_expand_kernel_terminals_only(card):
    S, W = 1000, 1037
    tabs = [torch.full((S,), -1, dtype=torch.int32, device=card),
            torch.full((S,), -1, dtype=torch.int32, device=card),
            torch.arange(S, dtype=torch.int32, device=card) * 3,
            torch.ones(S, dtype=torch.int32, device=card)]
    syms = torch.randint(0, S, (W,), dtype=torch.int32, device=card)
    got = _counted("grammar_expand", K5.grammar_expand, syms, *tabs,
                   max_depth=4)
    assert torch.equal(got[:, 0], syms * 3) and not got[:, 1:].any()


def _k5_hand_tables():
    """Terminals 0-7, a left-deep chain of rules (depth 7), and rules of
    16, 25, 32, 33, 41, 57 and 64 gaps over it (the tables of
    ``tests/test_torch_kernels.py::_hand_tables``)."""
    sums, left, right, lens = [3, 1, 4, 1, 5, 9, 2, 6], [-1] * 8, [-1] * 8, \
        [1] * 8

    def rule(l, r):
        left.append(l)
        right.append(r)
        sums.append(sums[l] + sums[r])
        lens.append(lens[l] + lens[r])
        return len(left) - 1

    x = rule(0, 1)
    for t in range(2, 8):
        x = rule(x, t)
    y = rule(3, x)
    a = rule(x, x)
    b = rule(a, y)
    c = rule(b, a)
    rule(c, a)
    e = rule(a, a)
    rule(e, 5)
    rule(e, e)
    return [np.asarray(t, np.int32) for t in (left, right, sums, lens)]


@pytest.mark.parametrize("lens_case", ["consistent", "disagree"])
def test_grammar_expand_kernel_hand_tables(card, lens_case):
    """Every symbol of the hand-made tables, ids outside them, at every
    depth; W = 269, no multiple of a warp's 8 rows or a block's 32."""
    left, right, sums, lens = _k5_hand_tables()
    S = lens.size
    if lens_case == "disagree":
        rng = np.random.default_rng(18)
        odd = rng.choice(S, size=S // 2, replace=False)
        lens[odd] = rng.choice(np.array(
            [-7, 0, 1, 2, 5, 31, 33, 40, 2**31 - 1, -2**31, -2**31 + 3],
            np.int64), size=odd.size).astype(np.int32)
    rng = np.random.default_rng(7)
    syms = np.concatenate([np.arange(S), [-1, S, S + 5],
                           rng.integers(0, S, 269 - S - 3)]
                          ).astype(np.int32)
    assert syms.size % 8 and syms.size % 32
    tabs = [torch.from_numpy(t).to(card) for t in (left, right, sums, lens)]
    x = torch.from_numpy(syms).to(card)
    for depth in range(0, 12):
        got = _counted("grammar_expand", K5.grammar_expand, x, *tabs,
                       max_depth=depth)
        assert torch.equal(got, K5.grammar_expand_plain(x, *tabs,
                                                        max_depth=depth))
        assert not got[S:S + 3].any()


@pytest.mark.parametrize("W, half", [(373_111, False), (100_003, True),
                                     (1_037, False)])
def test_grammar_expand_kernel_smoke_shapes(card, cres, W, half):
    """The smoke's three launches' shapes over a real grammar's symbols:
    the main launch, the cut one at half depth and a small one."""
    fi = TI.build_flat_index(cres, device=card)
    tabs = [fi.sym_left, fi.sym_right, fi.sym_sum, fi.sym_len]
    depth = fi.max_depth // 2 if half else fi.max_depth
    S = int(fi.sym_len.numel())
    syms = torch.from_numpy(np.random.default_rng(W).integers(
        0, S, W).astype(np.int32)).to(card)
    got = _counted("grammar_expand", K5.grammar_expand, syms, *tabs,
                   max_depth=depth)
    assert torch.equal(got, K5.grammar_expand_plain(syms, *tabs,
                                                    max_depth=depth))


# -- K4's hash-table design at its edges --------------------------------------

def _k4_oracle(ca, cb, pa, pb, vm):
    """numpy counts: one ``np.unique`` of the valid slots' 64-bit keys,
    then a lookup per candidate (``-1`` candidates count 0)."""
    key = lambda a, b: a.astype(np.int64) * 2**32 + (b.astype(np.int64)
                                                      & 0xFFFFFFFF)
    uniq, cnt = np.unique(key(pa, pb)[vm != 0], return_counts=True)
    uniq = np.append(uniq, np.iinfo(np.int64).max)
    cnt = np.append(cnt, 0)
    k = key(ca, cb)
    pos = np.searchsorted(uniq, k)
    return np.where((uniq[pos] == k) & (ca >= 0), cnt[pos], 0)


def _k4_check(card, ca, cb, pa, pb, vm, offset=0):
    """K4 on the card == its plain version == the numpy oracle, one launch;
    ``offset`` > 0 passes the stream as views that are not 16-byte
    aligned."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(card)
    cand = [t(ca), t(cb)]
    stream = [t(np.concatenate([np.zeros(offset, np.int32), x]))[offset:]
              for x in (pa, pb, vm)]
    got = _counted("pair_count", K4.pair_count, *cand, *stream)
    assert torch.equal(got, K4.pair_count_plain(*cand, *stream))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _k4_oracle(ca, cb, pa, pb, vm))
    return got.cpu().numpy()


def test_pair_count_colliding_keys(card):
    """A full 4,096-key table whose keys crowd eight home slots (long
    probe chains), half of the stream drawn from those keys and half from
    absent keys with the same home slots (misses walk the chains)."""
    rng = np.random.default_rng(21)
    bits = K4.count_plan(4096, 1, 132).bits
    a = rng.integers(0, 2**20, 4_000_000)
    b = rng.integers(0, 2**20, 4_000_000)
    home = K4.pair_slot(a, b, bits)
    crowd = np.nonzero(home < 8)[0]
    assert crowd.size > 1200
    keys = crowd[:1000]
    absent = crowd[1000:1200]
    ca = np.concatenate([a[keys], rng.integers(0, 2**20, 3096)])
    cb = np.concatenate([b[keys], rng.integers(0, 2**20, 3096)])
    pick = np.concatenate([rng.choice(keys, 50_000), rng.choice(absent,
                                                                50_000)])
    got = _k4_check(card, ca, cb, a[pick], b[pick],
                    (rng.random(pick.size) < 0.9).astype(np.int32))
    assert got[:1000].sum() > 40_000


def test_pair_count_one_pair_over_whole_stream(card):
    """One pair in every slot of a round-1-sized stream (every lane of
    every warp hits one bin), with its duplicate and sentinels around it."""
    n = 954_112
    ca = np.full(4096, -1, np.int32)
    cb = np.full(4096, -1, np.int32)
    ca[[0, 17, 4095]], cb[[0, 17, 4095]] = (3, 3, 4), (4, 4, 3)
    got = _k4_check(card, ca, cb, np.full(n, 3), np.full(n, 4),
                    np.ones(n, np.int32))
    assert got[0] == got[17] == n and not got[4095] and got.sum() == 2 * n


@pytest.mark.parametrize("K", [1, 8192, 32_768])
def test_pair_count_table_sizes(card, K):
    """K = 1; and tables above one block's 4,096 keys (two and eight
    chunks), with duplicates across the chunks."""
    rng = np.random.default_rng(K)
    n = 300_001
    alphabet = 200
    ca = rng.integers(0, alphabet, K).astype(np.int32)
    cb = rng.integers(0, alphabet, K).astype(np.int32)
    ca[K // 2:] = np.roll(ca[:K - K // 2], 3)     # copies in other chunks
    pa = rng.integers(0, alphabet, n)
    pb = rng.integers(0, alphabet, n)
    got = _k4_check(card, ca, cb, pa, pb, np.ones(n, np.int32))
    assert got.sum() > 0


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 4097, 300_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_pair_count_stream_tails(card, n, offset):
    """N not a multiple of 4 and N = 0 (the scalar tail of the 16-byte
    loads), and streams that are not 16-byte aligned."""
    rng = np.random.default_rng(n + offset)
    ca = rng.integers(0, 6, 1037).astype(np.int32)
    cb = rng.integers(0, 6, 1037).astype(np.int32)
    got = _k4_check(card, ca, cb, rng.integers(0, 6, n),
                    rng.integers(0, 6, n),
                    (rng.random(n) < 0.8).astype(np.int32), offset)
    assert n < 5 or got.sum() > 0


def test_pair_count_sentinels_and_duplicates_in_any_order(card):
    """A shuffled table: ``-1`` candidates anywhere (with any right),
    real keys whose right is -1, each key copied up to five times at
    random places; a stream with -1 symbols in valid slots."""
    rng = np.random.default_rng(23)
    base = rng.integers(0, 40, (700, 2))
    base[:30, 1] = -1                              # a real key (a, -1)
    copies = np.repeat(base, rng.integers(1, 6, 700), axis=0)
    table = np.concatenate([copies, np.stack(
        [np.full(400, -1), rng.integers(-1, 40, 400)], 1)])
    table = table[rng.permutation(len(table))].astype(np.int32)
    n = 200_000
    pa = rng.integers(-1, 40, n)
    pb = rng.integers(-1, 40, n)
    got = _k4_check(card, table[:, 0], table[:, 1], pa, pb,
                    (rng.random(n) < 0.85).astype(np.int32))
    assert not got[table[:, 0] < 0].any() and got.sum() > 0


# -- K2's tiled design at its edges --------------------------------------------

@pytest.fixture(scope="module")
def k2_res():
    """A list of 20,000 consecutive documents (one gap, phrases doubling
    in length) beside singletons, short random lists and a wide random
    list."""
    rng = np.random.default_rng(31)
    lists = ([np.arange(1000, 21_000, dtype=np.int64)]
             + [np.asarray([int(x)]) for x in rng.integers(0, 30_000, 8)]
             + [np.unique(rng.integers(0, 30_000, int(rng.integers(2, 60))))
                for _ in range(10)]
             + [np.unique(rng.integers(0, 30_000, 3000))])
    return lists, repair_compress(lists)


@pytest.mark.parametrize("variant", ["lists", "tile_edges", "empty",
                                     "cut_depth", "wrap"])
@pytest.mark.parametrize("page", [2048, 128])
def test_page_score_edges(card, k2_res, page, variant):
    """Every directory entry (the 20,000-slot entry at page 2048 beside
    entries of 1) with: its own metadata (rows == the lists' slices);
    counts on, just below and just past 128- and 256-slot edges; count 0,
    an empty window with and without the head; a cut ``max_depth``; bases
    near INT_MAX, so sums wrap — kernel == plain version."""
    lists, res = k2_res
    pt = TI.build_paged_index(TI.build_flat_index(res, device=card), page)
    si = TI.build_score_index(res, page_size=page)
    tables, statics = K2.pad_score_operands(pt)
    e = np.arange(si.pg_list.size)
    pages = si.pg_page[e].astype(np.int64)
    meta = [pages, si.pg_sym_lo[e] - pages * page,
            si.pg_sym_hi[e] - si.pg_sym_lo[e], si.pg_base[e],
            si.pg_head[e], si.pg_count[e]]
    meta = [np.asarray(m, np.int64).copy() for m in meta]
    b_pad = max(128, 1 << (int(si.max_page_elems) - 1).bit_length())
    if page == 2048:
        assert si.pg_count.max() == 20_000 and b_pad == 32_768
        assert (si.pg_count == 1).any()
    depth = statics["max_depth"]
    if variant == "tile_edges":
        wide = np.argsort(si.pg_count)[::-1][:6]
        meta[5][wide] = [127, 128, 129, 255, 256, 257]
    elif variant == "empty":
        meta[5][:3] = 0
        meta[2][3:6] = 0
        meta[4][3], meta[4][4] = 1, 0
        meta[5][3:6] = 1
    elif variant == "cut_depth":
        depth = max(1, depth // 2)
    elif variant == "wrap":
        meta[3][::2] = 2**31 - 100
    t = [torch.from_numpy(np.ascontiguousarray(m, np.int32)).to(card)
         for m in meta]
    kw = dict(b_pad=b_pad, max_depth=depth, T=statics["T"])
    got = _counted("page_score", K2.page_score, *t, tables, **kw)
    assert torch.equal(got, K2.page_score_plain(*t, tables, **kw))
    if variant == "lists":
        rows = got.cpu().numpy()
        for q in e.tolist():
            lo, c = int(si.pg_elem_lo[q]), int(si.pg_count[q])
            np.testing.assert_array_equal(
                rows[q, :c], lists[int(si.pg_list[q])][lo:lo + c])
            assert (rows[q, c:] == INF).all()


# -- K3 redesigned: the sample page in registers, fused selects -------------

def _k3_hold(card, lists, lids, xs, pack=None):
    """K3 on the card == its plain version == the numpy reference == the
    set oracle, with one launch."""
    store = EF.build_ef_store(lists, 2**31 - 1)
    rank = store.select_samples()
    pack = K3.pad_ef_operands(store, rank, card) if pack is None else pack
    lids = np.asarray(lids, np.int32)
    xs = np.clip(np.asarray(xs, np.int64), -2**31, 2**31 - 1).astype(np.int32)
    lt, xt = torch.from_numpy(lids).to(card), torch.from_numpy(xs).to(card)
    got = _counted("ef_next_geq", K3.ef_next_geq, lt, xt, pack)
    assert torch.equal(got, K3.ef_next_geq_plain(lt, xt, pack))
    want = EF.ef_next_geq_np(store, rank, lids, xs)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    live = [v if v is not None else np.zeros(0, np.int64) for v in lists]
    np.testing.assert_array_equal(want, _oracle(live, lids, xs))
    return store, rank


def _k3_every_x(lists, pad=2):
    """Every probe from pad below a list's head to pad past its tail: every
    select of every bucket, at every word and sample-page boundary."""
    lids, xs = [], []
    for t, v in enumerate(lists):
        if v is None:
            continue
        span = np.arange(int(v[0]) - pad, int(v[-1]) + pad + 1)
        lids.append(np.full(span.size, t))
        xs.append(span)
    return np.concatenate(lids), np.concatenate(xs)


def test_ef_next_geq_selects_at_page_boundaries(card):
    """Dense and clustered lists probed at every x: zero hx - 1 and zero hx
    in different words and different sample pages (zero 127 of 0..1999 is
    bit 255, the last of page 0, and zero 128 is bit 257), ones and zeros
    across pages, buckets spanning words, l = 0 and l = 1 lists."""
    rng = np.random.default_rng(23)
    lists = [np.arange(2000), np.arange(0, 6000, 3), np.arange(7, 4000, 2),
             np.unique(np.concatenate([rng.integers(b, b + 60, 50) for b in
                                       range(0, 9000, 300)])),
             np.unique(rng.integers(0, 5000, 2500)),
             np.unique(rng.integers(0, 40_000, 300))]
    store, _ = _k3_hold(card, lists, *_k3_every_x(lists))
    assert store.lbits[0] == 0 and store.lbits[1] == 1
    assert (store.hi_word[1:] - store.hi_word[:-1]).max() >= 24


def test_ef_next_geq_wide_lists_and_extreme_probes(card):
    """l = 31 (the singleton INT_MAX) and l = 30 lists beside l = 0, probed
    at INT_MIN, -1, 0, INT_INF, the head, the tail and one past it."""
    lists = [np.asarray([2**31 - 1]), np.asarray([5, 2**31 - 1]),
             np.asarray([2**30 + 9]), np.arange(300), None,
             np.asarray([0]), np.asarray([3, 2**31 - 2])]
    store = EF.build_ef_store(lists, 2**31 - 1)
    assert store.lbits[0] == 31 and store.lbits[1] == 30
    lids, xs = [], []
    for t, v in enumerate(lists):
        cand = [-2**31, -1, 0, 1, 2**31 - 1, 2**31 - 2]
        if v is not None:
            cand += [v[0], v[0] - 1, v[0] + 1, v[-1], v[-1] - 1, v[-1] + 1]
        lids += [t] * len(cand)
        xs += cand
    _k3_hold(card, lists, lids, xs)


def test_ef_next_geq_unaligned_high_words(card):
    """A pack whose hi_words is an offset view (4 bytes past a 16-byte
    boundary): the kernel reads the sample page word by word and gives
    the same answers."""
    rng = np.random.default_rng(29)
    lists = [np.unique(rng.integers(0, 9000, int(n))) for n in
             (3000, 40, 700, 1)] + [np.arange(1000)]
    store = EF.build_ef_store(lists, 2**31 - 1)
    rank = store.select_samples()
    pack = K3.pad_ef_operands(store, rank, card)
    hw = pack["hi_words"]
    pack["hi_words"] = torch.cat([hw[:1], hw])[1:]
    assert pack["hi_words"].is_contiguous()
    assert pack["hi_words"].data_ptr() % 16 != 0
    lids = rng.integers(0, len(lists), 20_000)
    xs = rng.integers(-3, 9100, 20_000)
    l2, x2 = _k3_every_x(lists[-1:])
    _k3_hold(card, lists, np.concatenate([lids, l2 + len(lists) - 1]),
             np.concatenate([xs, x2]), pack=pack)


# -- K7 redesigned: a hash set of each row of b -------------------------------

@pytest.mark.parametrize("case", [
    "chunked", "table_multiples", "block_multiples", "bucketized",
    "all_inf", "cap_not_mult_4", "negative", "duplicates"])
def test_bucket_intersect_hash_edges(card, case):
    """The hash-set design's edges: a row of b past one shared-memory
    table (b entered in chunks), values that share a home slot
    (multiples of the 256-slot warp table and of a block's 4,096-slot
    table; bucketized rows sharing their high bits), all-INT_INF rows,
    CAP not a multiple of 4 on both sides of the warp / block split,
    negative values and heavy duplicates — kernel == plain == numpy."""
    rng = np.random.default_rng(len(case))
    nb, cap = dict(chunked=(3, 9000), block_multiples=(4, 1500),
                   cap_not_mult_4=(9, 127)).get(case, (40, 128))
    draw = lambda lo, hi: rng.integers(lo, hi, (nb, cap))
    if case == "chunked":
        a, b = draw(0, 12_000), draw(0, 12_000)
    elif case == "table_multiples":
        a, b = draw(-40, 40) * 256, draw(-40, 40) * 256
    elif case == "block_multiples":
        a, b = draw(-300, 300) * 4096, draw(-300, 300) * 4096
    elif case == "bucketized":
        high = rng.integers(0, 2**24, (nb, 1)) << 7
        a, b = high + draw(0, 128), high + draw(0, 128)
    elif case == "all_inf":
        a, b = draw(0, 50), draw(0, 50)
        a[::3], b[1::3] = INF, INF
    elif case == "cap_not_mult_4":
        a, b = draw(0, 90), draw(0, 90)
    elif case == "negative":
        a, b = draw(-2**31, -2**31 + 200), draw(-2**31, -2**31 + 200)
    else:
        a, b = draw(0, 3), draw(0, 3)
    a, b = a.astype(np.int32), b.astype(np.int32)
    a[rng.random(a.shape) < 0.05] = INF
    b[rng.random(b.shape) < 0.05] = INF
    ta, tb = (torch.from_numpy(x).to(card) for x in (a, b))
    got = _counted("bucket_intersect", K7.bucket_intersect, ta, tb)
    assert torch.equal(got, K7.bucket_intersect_plain(ta, tb))
    hit = (a != INF) & np.stack([np.isin(a[r], b[r]) for r in range(nb)])
    np.testing.assert_array_equal(got.cpu().numpy(), np.where(hit, a, INF))
    if case == "cap_not_mult_4":
        t5 = tuple(torch.from_numpy(np.ascontiguousarray(x[:5, :125]))
                   .to(card) for x in (a, b))
        assert torch.equal(_counted("bucket_intersect", K7.bucket_intersect,
                                    *t5), K7.bucket_intersect_plain(*t5))


# -- K1's one-shot surface ---------------------------------------------------

def test_one_shot_surface_on_card_matches_cpu(card, clists, cres):
    """``next_geq``, ``next_geq_probe`` and ``list_intersect`` on the card
    (K1 launched) equal the same functions with ``device="cpu"``, for a
    flat index on the CPU and a paged one on the card."""
    ft = TI.build_flat_index(cres, device="cpu")
    pt = TI.build_paged_index(TI.build_flat_index(cres, device=card), 128)
    lids, xs = _lanes(clists, cres.universe, n=2000)
    rng = np.random.default_rng(31)
    ids = rng.integers(0, len(clists), 6).astype(np.int32)
    rows = np.full((6, 64), INF, np.int32)
    for r in range(6):
        n = int(rng.integers(1, 64))
        rows[r, :n] = np.sort(rng.integers(0, cres.universe, n))
    for index in (ft, pt):
        n0 = KR.LAUNCHES["list_intersect"]
        got = K1.next_geq(index, lids, xs)
        assert KR.LAUNCHES["list_intersect"] == n0 + 1
        np.testing.assert_array_equal(got, K1.next_geq(index, lids, xs,
                                                       device="cpu"))
        np.testing.assert_array_equal(got, _oracle(clists, lids, xs))
        np.testing.assert_array_equal(
            K1.next_geq_probe(index, ids, rows),
            K1.next_geq_probe(index, ids, rows, device="cpu"))
        np.testing.assert_array_equal(
            K1.list_intersect(index, ids, rows),
            K1.list_intersect(index, ids, rows, device="cpu"))


# -- the LM tier ----------------------------------------------------------------

LM_ARCHS = ["qwen3-32b", "yi-6b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b"]


def _lm_recorded():
    """``chip_smoke.lm_recorded``: the engine with its prefills and steps
    recorded (and, given another run's records, teacher-forced)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lm_recorded


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_engine_on_card_matches_cpu(card, name):
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeConfig
    cfg = get_arch(name).smoke_config
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(card)
    assert gpu.device == card
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, int(rng.integers(3, 12)))
               for _ in range(6)]
    scfg = ServeConfig(max_batch=3, s_cache=32, max_new_tokens=9)
    lm_recorded = _lm_recorded()
    done_c, ev_c = lm_recorded(cpu, scfg, prompts, "cpu")
    done_g, ev_g = lm_recorded(gpu, scfg, prompts, card, forced=ev_c)
    assert done_g == done_c and len(done_c) == len(prompts)
    assert len(ev_g) == len(ev_c)
    for (ig, lg, xg), (ic, lc, xc) in zip(ev_g, ev_c):
        for a, b in zip(ig, ic):
            assert torch.equal(a.cpu(), b.cpu())
        np.testing.assert_array_equal(lg, lc)
        torch.testing.assert_close(xg, xc, rtol=2e-2, atol=2e-2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))).to(card)
    full, _ = gpu(toks)
    last, cache = gpu.prefill(toks)
    assert all(v.device == card for v in cache.values())
    torch.testing.assert_close(last, full[:, -1], rtol=2e-2, atol=2e-2)


def test_matmul_f32_grad_on_card_matches_cpu(card):
    """The logits' product on the card has a gradient: the float32 output
    and the bf16 gradients of both operands against the CPU's autograd
    through its upcasts, each gradient within one bf16 ulp (both round the
    same float32 product once; the sums run in another order)."""
    from repro_torch.models.layers import matmul_f32
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 24, 96), generator=g).to(torch.bfloat16)
    w = torch.randn((96, 200), generator=g).mul(0.1).to(torch.bfloat16)
    up = torch.randn((2, 24, 200), generator=g)
    outs = {}
    for dev in ("cpu", card):
        xd = x.to(dev).detach().requires_grad_(True)
        wd = w.to(dev).detach().requires_grad_(True)
        y = matmul_f32(xd, wd)
        assert y.dtype == torch.float32
        (y * up.to(dev)).sum().backward()
        assert xd.grad.dtype == wd.grad.dtype == torch.bfloat16
        outs[str(dev)] = (y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu(),
                          type(y.grad_fn.next_functions[0][0]).__name__)
    yc, gxc, gwc, _ = outs["cpu"]
    yg, gxg, gwg, fn = outs[str(card)]
    assert "MatmulF32" in fn
    torch.testing.assert_close(yg, yc, rtol=1e-5, atol=1e-5)
    for got, want in ((gxg, gxc), (gwg, gwc)):
        ulp = torch.from_numpy(np.spacing(
            want.float().abs().numpy().astype("float32")) * 2 ** 16)
        assert torch.all((got.float() - want.float()).abs() <= ulp)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_train_step_on_card_matches_cpu(card, name):
    """One step of the train step (loss, backward with the layers
    recomputed, AdamW in place) on the card against the same parameters
    and batch on the CPU: loss, grad norm and every parameter within 2e-2
    (parameters × their leaf's max |p|), moments finite."""
    import copy
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.convert import lm_params_to_numpy
    from repro_torch.models.transformer import init_params
    from repro_torch.train.loop import _trainable, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.tree import leaves, leaves_with_paths
    cfg = get_arch(name).smoke_config
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = copy.deepcopy(cpu).to(card)
    batch = SyntheticLMDataset(DataConfig(seq_len=16, global_batch=4,
                                          vocab=cfg.vocab)).batch_at(0)
    step = make_train_step(lambda m, b: m.lm_loss(b["tokens"], b["targets"]),
                           AdamWConfig(lr=1e-3, warmup_steps=0))
    res = {}
    for model in (cpu, gpu):
        dev = model.device
        _, st, met = step(_trainable(model), init_opt_state(model),
                          {k: torch.from_numpy(v).to(dev)
                           for k, v in batch.items()})
        assert all(torch.isfinite(t).all() for t in leaves(st.mu))
        res[dev.type] = (float(met["loss"]), float(met["grad_norm"]))
    for a, b in zip(res["cuda"], res["cpu"]):
        assert abs(a - b) <= 2e-2 * abs(b)
    on_card = dict(leaves_with_paths(lm_params_to_numpy(gpu)))
    for path, a in leaves_with_paths(lm_params_to_numpy(cpu)):
        assert np.abs(a - on_card[path]).max() <= 2e-2 * np.abs(a).max(), \
            path


def _grid(dev, dd: int, mm: int):
    from repro_torch.distributed import Mesh
    return Mesh(np.full((dd, mm), str(dev), dtype=object), ("data", "model"))


@pytest.mark.parametrize("E, shape, pad", [(5, (1, 2), False),
                                           (5, (2, 2), False),
                                           (5, (1, 5), False),
                                           (5, (1, 2), True),
                                           (4, (2, 2), False)])
def test_moe_sharded_on_card_matches_cpu(card, E, shape, pad):
    from repro_torch.models.moe import init_moe, moe_ffn_sharded
    p = init_moe(torch.Generator().manual_seed(E), 64, 32, E)
    x = torch.randn((24, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    kw = dict(n_experts=E, top_k=2, capacity_factor=1.25, dp_spec="data",
              tp_axis="model", ep_pad=pad)
    yc, ac = moe_ffn_sharded(p, x, mesh=_grid("cpu", *shape), **kw)
    yg, ag = moe_ffn_sharded({k: v.to(card) for k, v in p.items()},
                             x.to(card), mesh=_grid(card, *shape), **kw)
    assert yg.device == card and ag.device == card
    torch.testing.assert_close(yg.cpu().float(), yc.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-5, atol=1e-6)


def test_meshed_lm_on_card_matches_cpu(card):
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    base = get_arch("granite-moe-3b-a800m").smoke_config
    cpu = init_params(dataclasses.replace(
        base, mesh=_grid("cpu", 2, 2), dp_spec="data", tp_axis="model"),
        torch.Generator().manual_seed(0), "cpu")
    gpu = copy.deepcopy(cpu).to(card)
    for blk in gpu.blocks:
        blk.cfg = dataclasses.replace(blk.cfg, mesh=_grid(card, 2, 2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab, (2, 12)))
    (lc, ac), (lg, ag) = cpu(toks), gpu(toks.to(card))
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(ag.cpu(), ac, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n", [2, 3])
def test_compressed_psum_on_card_bit_exact(card, n):
    from repro_torch.distributed import Mesh
    from repro_torch.train.optimizer import compressed_psum_with_feedback
    gen = torch.Generator().manual_seed(n)
    shapes = {"w": (33, 70), "g": (1000,), "s": ()}

    def grads():
        return [{k: (torch.randn(s, generator=gen) * (i + 1) ** 3).to(
            torch.bfloat16 if k == "g" else torch.float32)
            for k, s in shapes.items()} for i in range(n)]

    res = {}
    steps = [grads() for _ in range(3)]
    for dev in ("cpu", card):
        mesh = Mesh([dev] * n)
        err = [{k: torch.zeros(s, device=dev) for k, s in shapes.items()}
               for _ in range(n)]
        outs = []
        for g in steps:
            g = [{k: v.to(dev) for k, v in t.items()} for t in g]
            out, err = compressed_psum_with_feedback(g, err, "data", mesh)
            outs.append((out, err))
        res[str(dev)] = outs
    for (oc, ec), (og, eg) in zip(res["cpu"], res[str(card)]):
        for i in range(n):
            for k in shapes:
                assert torch.equal(og[i][k].cpu(), oc[i][k]), k
                assert torch.equal(eg[i][k].cpu(), ec[i][k]), k


def test_pipeline_on_card_matches_cpu(card):
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.pipeline import (mlp_reference,
                                                  mlp_stage_fn,
                                                  pipeline_apply,
                                                  stack_mlp_params)
    p = stack_mlp_params(torch.Generator().manual_seed(0), 8, 64,
                         device="cpu")
    x = torch.randn((12, 64), generator=torch.Generator().manual_seed(1))
    got = {}
    for dev in ("cpu", card):
        pp = {k: v.detach().clone().to(dev).requires_grad_()
              for k, v in p.items()}
        y = pipeline_apply(Mesh([dev] * 4, ("stage",)), "stage", 3,
                           mlp_stage_fn, pp, x.to(dev))
        (y ** 2).sum().backward()
        pr = {k: v.detach().clone().to(dev).requires_grad_()
              for k, v in p.items()}
        r = mlp_reference(pr, x.to(dev))
        (r ** 2).sum().backward()
        torch.testing.assert_close(y, r, rtol=1e-5, atol=1e-5)
        for k in p:
            torch.testing.assert_close(pp[k].grad, pr[k].grad, rtol=1e-4,
                                       atol=1e-4)
        got[str(dev)] = (y.detach().cpu(), pp["w"].grad.cpu())
    torch.testing.assert_close(got[str(card)][0], got["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got[str(card)][1], got["cpu"][1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", ["yi-6b", "granite-moe-3b-a800m"])
def test_dryrun_counts_equal_card_run(card, name, kind):
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import Mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import leaves_with_paths, parts
    a = get_arch(name)
    arch = dataclasses.replace(a, config=a.smoke_config)
    # the spec on a (1, 1) mesh of meta entries (the MoE runs its body per
    # coordinate on the mesh's devices); the card's model on cuda:0's
    mesh = Mesh([["meta"]], ("data", "model"))
    gen = torch.Generator(card).manual_seed(0)

    def on_card(cfg):
        return init_params(dataclasses.replace(cfg, mesh=Mesh(
            [[card]], ("data", "model"))), gen, card)

    if kind == "train":
        spec = SP.lm_train_spec(arch, ShapeSpec("t", "train", {
            "seq": 64, "batch": 2}), mesh)
        model = on_card(spec.args[0].cfg)
        args = (model, init_opt_state(model), {
            k: torch.randint(0, model.cfg.vocab, (2, 64), generator=gen,
                             device=card, dtype=torch.int32)
            for k in ("tokens", "targets")})
    else:
        spec = SP.lm_decode_spec(arch, ShapeSpec("d", "decode", {
            "seq": 64, "batch": 4}), mesh)
        model = on_card(spec.args[0].cfg)
        args = (model, torch.zeros(4, dtype=torch.int32, device=card),
                model.init_cache(4, 64),
                torch.tensor([15, 31, 47, 63], dtype=torch.int32,
                             device=card))
    dry = D.count_spec(spec)
    with FlopCounterMode(display=False) as fc:
        spec.fn(*args)
    real = sum(p.numel() * p.element_size() for tree in args
               for _, leaf in leaves_with_paths(tree) for p in parts(leaf))
    assert dry.flops == fc.get_total_flops() > 0
    assert dry.argument_bytes == real


def test_restore_shardings_on_card(card, tmp_path):
    import numpy as np_
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Mesh, P, shard_tensor
    from repro_torch.distributed.sharding import lm_param_spec, spec_tree
    from repro_torch.launch.specs import spec_leaves
    from repro_torch.models.transformer import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import Stacked, leaves_with_paths
    cfg = get_arch("yi-6b").smoke_config
    model = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    state = {"params": model, "x": torch.arange(12, device=card)}
    saved = {p: (v.stack() if isinstance(v, Stacked) else v).detach()
             for p, v in leaves_with_paths(state)}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state)
    for grid in ((2, 2), (1, 4)):
        mesh = Mesh(np_.full(grid, card, dtype=object), ("data", "model"))
        specs = {"params": spec_tree(model, lambda p, s, m: lm_param_spec(
            p, s, m), mesh), "x": P("model")}
        pairs = {"params": {}, "x": (mesh, specs["x"])}

        def wrap(t):
            return (mesh, t) if isinstance(t, P) else {
                k: wrap(v) for k, v in t.items()}

        pairs["params"] = wrap(specs["params"])
        got, _ = cm.restore(1, state, shardings=pairs)
        flat = {}

        def walk(t, prefix=""):
            if isinstance(t, list):
                flat[prefix] = t
                return
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)

        walk(got)
        cuts = spec_leaves(specs)
        assert sorted(flat) == sorted(saved)
        for path, shards in flat.items():
            want = shard_tensor(saved[path], cuts[path], mesh)
            assert all(a.device == card and torch.equal(a, w)
                       for a, w in zip(shards, want)), path
