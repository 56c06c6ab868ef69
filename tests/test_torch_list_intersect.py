"""Kernel K1 (``list_intersect``) and the probe programs of the port.

The plain version of K1, fed by the port's copy of the host router, must
equal the JAX package's Pallas kernel (interpret mode) and its paged jnp
program lane for lane, at page 2048 and at page 128 — where skip windows
straddle pages — including the edge lanes: the head, the last element,
one past it, beyond the universe, singleton lists.  The torch probe
programs (flat, paged, [BY04] binary search) must equal their jnp
counterparts.  The CUDA kernel itself is held to the plain version on the
card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import jax_index as JI
from repro.core.repair import repair_compress as repair_jax
from repro.engine import jnp_backend as JB
from repro.kernels.list_intersect import ops as KJ

from repro_torch import kernels as KR
from repro_torch.core import index as TI
from repro_torch.core.repair import repair_compress
from repro_torch.engine import torch_backend as TB
from repro_torch.kernels.list_intersect import ops as K

CPU = torch.device("cpu")
INF = int(TI.INT_INF)


@pytest.fixture(scope="module")
def klists():
    """Dense runs (deep phrases, page-straddling skip windows at page 128),
    random lists, and a singleton."""
    rng = np.random.default_rng(11)
    u = 20_000
    lists = [np.unique(rng.choice(u, size=int(rng.integers(20, 400)),
                                  replace=False)) for _ in range(14)]
    lists.append(np.arange(0, 2400, dtype=np.int64))
    lists.append(np.arange(5000, 9000, 3, dtype=np.int64))
    lists.append(np.asarray([u - 3]))
    return lists


@pytest.fixture(scope="module")
def kres(klists):
    return repair_jax(klists), repair_compress(klists)


def _lanes(lists, universe, n=240, seed=3):
    """Random lanes plus every edge lane of every list."""
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


@pytest.fixture(scope="module", params=[2048, 128])
def packs(request, kres):
    rj, rt = kres
    page = request.param
    pj = JI.build_paged_index(JI.build_flat_index(rj), page_size=page)
    pt = TI.build_paged_index(TI.build_flat_index(rt, device=CPU), page)
    return pj, pt, K.pad_paged_operands(pt)


def test_corpus_straddles_pages(packs):
    pj, pt, _ = packs
    if pt.page_size == 128:
        assert pt.num_pages >= 4


def test_router_start_state_identical(packs, klists, kres):
    """The copied router computes the JAX router's start state and page
    windows for every lane."""
    pj, _, (_, _, host) = packs
    _, _, host_j = KJ.pad_paged_operands(pj)
    lids, xs = _lanes(klists, kres[0].universe)
    a = K._probe_windows(host, lids.astype(np.int64), xs.astype(np.int64))
    b = KJ._probe_windows(host_j, lids.astype(np.int64),
                          xs.astype(np.int64))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_plain_k1_matches_pallas_and_jnp(packs, klists, kres):
    """Plain K1 through the port's router == the Pallas kernel
    (interpret) == the paged jnp program == the set oracle."""
    pj, _, (tables, statics, host) = packs
    lids, xs = _lanes(klists, kres[0].universe)
    got = K.next_geq_paged(tables, host, lids, xs, **statics)
    assert got.dtype == np.int32
    pallas = np.asarray(KJ.next_geq(pj, lids, xs, interpret=True))
    jnp_paged = np.asarray(JB.next_geq_batch_paged(pj, lids, xs))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jnp_paged)
    np.testing.assert_array_equal(got, _oracle(klists, lids, xs))


def test_route_sorts_by_anchor_page(packs, klists, kres):
    _, _, (_, _, host) = packs
    lids, xs = _lanes(klists, kres[0].universe)
    order, rl, rx, pos0, s0 = K.route_pages(host, lids, xs)
    np.testing.assert_array_equal(np.sort(order), np.arange(lids.size))
    np.testing.assert_array_equal(rl, lids[order])
    np.testing.assert_array_equal(rx, xs[order])
    needs, lo, _, _, _ = K._probe_windows(host, lids.astype(np.int64),
                                          xs.astype(np.int64))
    key = np.where(needs, lo, lo[needs].min() if needs.any() else 0)
    assert (np.diff(key[order]) >= 0).all()
    assert all(a.dtype == np.int32 for a in (rl, rx, pos0, s0))


def test_torch_probe_programs_match_jnp(packs, klists, kres):
    """Flat, paged, member, row-wise and [BY04] programs == jnp."""
    pj, pt, _ = packs
    fj, ft = pj.flat, pt.flat
    lids, xs = _lanes(klists, kres[0].universe, n=120)
    tl, tx = torch.from_numpy(lids), torch.from_numpy(xs)
    want = np.asarray(JB.next_geq_batch(fj, lids, xs))
    np.testing.assert_array_equal(TB.next_geq_batch(ft, tl, tx).numpy(),
                                  want)
    np.testing.assert_array_equal(
        TB.next_geq_batch_paged(pt, tl, tx).numpy(),
        np.asarray(JB.next_geq_batch_paged(pj, lids, xs)))
    np.testing.assert_array_equal(
        TB.member_batch_paged(pt, tl, tx).numpy(),
        np.asarray(JB.member_batch_paged(pj, lids, xs)))
    np.testing.assert_array_equal(TB.member_batch(ft, tl, tx).numpy(),
                                  np.asarray(JB.member_batch(fj, lids, xs)))
    incl_j, incl_t = JB.build_bys_table(fj), TB.build_bys_table(ft)
    np.testing.assert_array_equal(
        TB.next_geq_bys_batch(ft, incl_t, tl, tx).numpy(),
        np.asarray(JB.next_geq_bys_batch(fj, incl_j, lids, xs)))
    rows = xs[:120].reshape(4, 30)
    ids = np.asarray([0, 14, 15, 16], np.int32)
    np.testing.assert_array_equal(
        TB.probe_batch(ft, torch.from_numpy(ids),
                       torch.from_numpy(rows)).numpy(),
        np.asarray(JB.probe_batch(fj, ids, rows)))
    np.testing.assert_array_equal(
        TB.probe_batch_paged(pt, torch.from_numpy(ids),
                             torch.from_numpy(rows)).numpy(),
        np.asarray(JB.probe_batch_paged(pj, ids, rows)))


def test_wrapper_checks_operands(packs):
    _, _, (tables, statics, _) = packs
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K.list_intersect(q.long(), q, q, q, tables, **statics)
    with pytest.raises(ValueError, match="contiguous"):
        K.list_intersect(torch.zeros(8, dtype=torch.int32)[::2], q, q, q,
                         tables, **statics)
    with pytest.raises(ValueError, match="shape"):
        K.list_intersect(q, q[:3], q, q, tables, **statics)
    bad = dict(tables, sym_sum=tables["sym_sum"].to(torch.int64))
    with pytest.raises(ValueError, match="sym_sum"):
        K.list_intersect(q, q, q, q, bad, **statics)


def test_plain_version_counts_no_launch(packs, klists, kres):
    """On CPU tensors the wrapper runs the plain version: no kernel is
    built or launched, and nothing is counted."""
    _, _, (tables, statics, host) = packs
    before = dict(KR.LAUNCHES)
    lids, xs = _lanes(klists, kres[0].universe, n=16)
    K.next_geq_paged(tables, host, lids, xs, **statics)
    assert KR.LAUNCHES == before
