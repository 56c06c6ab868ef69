"""The CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is False.
The file imports nothing of JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

* ``list_intersect`` (K1): routed lanes with every edge lane, at page 2048
  and at page 128 — kernel == plain version == set oracle;
* ``page_score`` (K2): every block-max directory entry plus count-0 pad
  rows — kernel == plain version == the lists' slices;
* ``CudaEngine`` on the card == ``CudaEngine`` on the CPU for probes,
  intersections (short sides longer than one probe row among them) and
  ranked top-k, with every launch counted.
"""

import numpy as np
import pytest
import torch

from strategies import adversarial_lists

from repro_torch import kernels as KR
from repro_torch.core import index as TI
from repro_torch.core.repair import repair_compress
from repro_torch.engine import CudaEngine
from repro_torch.kernels.list_intersect import ops as K1
from repro_torch.kernels.page_score import ops as K2
from repro_torch.query import search_topk

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
    got = K1.list_intersect(*lanes, tables, **statics)
    torch.cuda.synchronize()
    assert KR.LAUNCHES["list_intersect"] == n0 + 1
    plain = K1.list_intersect_plain(*lanes, tables, **statics)
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
