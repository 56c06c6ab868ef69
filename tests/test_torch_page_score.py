"""Kernel K2 (``page_score``) and the page-decode programs of the port.

The plain version of K2, fed real block-max directory entries, must equal
the JAX package's Pallas kernel (interpret mode) row for row — tile-guarded
padding included — and the windowed jnp program, at page 2048 and at page
128, where lists straddle pages and entries start mid-page.  The entries
include a singleton list's head-only entry and pad entries of count 0.
"""

import numpy as np
import pytest
import torch

from strategies import adversarial_lists

from repro.core import jax_index as JI
from repro.core.repair import repair_compress as repair_jax
from repro.engine import jnp_backend as JB
from repro.kernels.page_score import ops as PSJ

from repro_torch import kernels as KR
from repro_torch.core import index as TI
from repro_torch.core.repair import repair_compress
from repro_torch.engine import torch_backend as TB
from repro_torch.kernels.page_score import ops as PS

CPU = torch.device("cpu")
INF = int(TI.INT_INF)


def score_lists():
    """A long incompressible list spanning several 128-symbol pages, a
    rare list drawn from its head, a dense run (long phrases), random
    lists and the adversarial shapes (a singleton among them)."""
    rng = np.random.default_rng(77)
    big = np.unique(rng.choice(4000, size=700, replace=False))
    return ([big, big[:40], np.arange(100, 1500, 2, dtype=np.int64)]
            + adversarial_lists(np.random.default_rng(5), universe=4000,
                                n_random=6, max_len=90))


@pytest.fixture(scope="module")
def slists():
    return score_lists()


@pytest.fixture(scope="module", params=[2048, 128])
def sstate(request, slists):
    """(page, jax paged index, port paged index, jax score index)."""
    page = request.param
    pj = JI.build_paged_index(JI.build_flat_index(repair_jax(slists)),
                              page_size=page)
    pt = TI.build_paged_index(
        TI.build_flat_index(repair_compress(slists), device=CPU), page)
    return page, pj, pt, JI.build_score_index(repair_jax(slists),
                                              page_size=page)


def _entry_meta(si, entries):
    """Per-entry kernel metadata, as the engines compute it."""
    e = np.asarray(entries, np.int64)
    pages = si.pg_page[e].astype(np.int64)
    return (pages, si.pg_sym_lo[e] - pages * si.page_size,
            si.pg_sym_hi[e] - si.pg_sym_lo[e], si.pg_base[e],
            si.pg_head[e], si.pg_count[e])


def _b_pad(si):
    return max(128, 1 << (max(1, int(si.max_page_elems)) - 1).bit_length())


def test_directory_exercises_edges(sstate):
    """Head-only entries always; at page 128 also continuation entries
    (no head) and windows that start mid-page."""
    page, _, pt, si = sstate
    assert ((si.pg_sym_hi == si.pg_sym_lo) & (si.pg_count == 1)).any()
    if page == 128:
        assert pt.num_pages >= 4
        assert (si.pg_head == 0).any()
        assert ((si.pg_sym_lo % page) != 0).any()


def test_plain_k2_matches_pallas_and_jnp(sstate, slists):
    """Every directory entry, plus count-0 pad rows: plain K2 == the
    Pallas kernel (interpret) == the windowed jnp decode == the lists."""
    _, pj, pt, si = sstate
    entries = np.arange(si.pg_list.size)
    meta = [np.concatenate([a, a[:2]]) for a in _entry_meta(si, entries)]
    meta[5][-2:] = 0                       # cnt 0: all padding
    b_pad = _b_pad(si)
    tables, statics = PS.pad_score_operands(pt)
    got = PS.page_decode(tables, statics, *meta, b_pad=b_pad)
    assert got.dtype == np.int32 and got.shape == (entries.size + 2, b_pad)
    tables_j, statics_j = PSJ.pad_score_operands(pj)
    want = PSJ.page_decode(tables_j, statics_j, *meta, b_pad=b_pad,
                           interpret=True)
    np.testing.assert_array_equal(got, want)
    assert (got[-2:] == INF).all()
    rows = np.asarray(JB.decode_pages_batch(
        pj.flat, si.pg_sym_lo, si.pg_sym_hi, si.pg_base, si.pg_head,
        win=int(si.page_size), max_elems=b_pad))
    np.testing.assert_array_equal(got[:-2], rows)
    for q, e in enumerate(entries):
        lo, c = int(si.pg_elem_lo[e]), int(si.pg_count[e])
        np.testing.assert_array_equal(
            got[q, :c], slists[int(si.pg_list[e])][lo:lo + c])
        assert (got[q, c:] == INF).all()


def test_torch_decode_programs_match_jnp(sstate):
    """The windowed page decode and the whole-list expansion == jnp."""
    _, pj, pt, si = sstate
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    b_pad = _b_pad(si)
    np.testing.assert_array_equal(
        TB.decode_pages_batch(pt.flat, t(si.pg_sym_lo), t(si.pg_sym_hi),
                              t(si.pg_base), t(si.pg_head),
                              win=int(si.page_size),
                              max_elems=b_pad).numpy(),
        np.asarray(JB.decode_pages_batch(
            pj.flat, si.pg_sym_lo, si.pg_sym_hi, si.pg_base, si.pg_head,
            win=int(si.page_size), max_elems=b_pad)))
    ids = np.arange(pt.flat.lengths.numel(), dtype=np.int32)
    for max_len in (16, 1024):
        np.testing.assert_array_equal(
            TB.expand_batch(pt.flat, t(ids), max_len).numpy(),
            np.asarray(JB.expand_batch(pj.flat, ids, max_len)))


def test_accumulate_scores_bit_identical():
    """Sequential float32 adds in term order, then one multiply: the same
    bits as the jnp reduction and the host reference."""
    rng = np.random.default_rng(9)
    idf = rng.random(6).astype(np.float32) * 7
    doc_w = rng.random(300).astype(np.float32) * 2
    member = rng.random((6, 300)) < 0.5
    got = TB.accumulate_scores_device(torch.from_numpy(idf),
                                      torch.from_numpy(doc_w),
                                      torch.from_numpy(member)).numpy()
    assert got.dtype == np.float32
    want = np.asarray(JB.accumulate_scores_device(idf, doc_w, member))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_wrapper_checks_operands(sstate):
    _, _, pt, si = sstate
    tables, statics = PS.pad_score_operands(pt)
    meta = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in _entry_meta(si, np.arange(4))]
    with pytest.raises(ValueError, match="multiple of 128"):
        PS.page_score(*meta, tables, b_pad=200, **statics)
    with pytest.raises(ValueError, match="int32"):
        PS.page_score(meta[0].long(), *meta[1:], tables, b_pad=128,
                      **statics)
    with pytest.raises(ValueError, match="shape"):
        PS.page_score(meta[0][:3], *meta[1:], tables, b_pad=128, **statics)
    bad = dict(tables, clens_pg=tables["clens_pg"][:, :64].contiguous())
    with pytest.raises(ValueError, match="differ"):
        PS.page_score(*meta, bad, b_pad=128, **statics)


def test_plain_version_counts_no_launch(sstate):
    _, _, pt, si = sstate
    tables, statics = PS.pad_score_operands(pt)
    before = dict(KR.LAUNCHES)
    PS.page_decode(tables, statics, *_entry_meta(si, np.arange(3)),
                   b_pad=_b_pad(si))
    assert KR.LAUNCHES == before



@pytest.mark.parametrize("variant", ["tile_edges", "empty", "cut_depth",
                                     "wrap"])
def test_plain_k2_edge_metadata_matches_pallas(sstate, variant):
    """The card tests' edge metadata on every directory entry: counts on,
    just below and just past the 128- and 256-slot edges; count 0 and
    empty windows with and without the head; a cut ``max_depth``; bases
    near INT_MAX, so sums wrap — plain K2 (the CPU wrapper) == the Pallas
    kernel (interpret)."""
    _, pj, pt, si = sstate
    meta = [np.asarray(m, np.int64).copy()
            for m in _entry_meta(si, np.arange(si.pg_list.size))]
    tables, statics = PS.pad_score_operands(pt)
    tables_j, statics_j = PSJ.pad_score_operands(pj)
    if variant == "tile_edges":
        wide = np.argsort(si.pg_count, kind="stable")[::-1][:6]
        meta[5][wide] = [127, 128, 129, 255, 256, 257][:wide.size]
    elif variant == "empty":
        meta[5][:3] = 0
        meta[2][3:6] = 0
        meta[4][3], meta[4][4] = 1, 0
        meta[5][3:6] = 1
    elif variant == "cut_depth":
        depth = max(1, statics["max_depth"] // 2)
        statics = dict(statics, max_depth=depth)
        statics_j = dict(statics_j, max_depth=depth)
    elif variant == "wrap":
        meta[3][::2] = 2**31 - 100
    b_pad = max(_b_pad(si), 512)
    got = PS.page_decode(tables, statics, *meta, b_pad=b_pad)
    want = PSJ.page_decode(tables_j, statics_j, *meta, b_pad=b_pad,
                           interpret=True)
    np.testing.assert_array_equal(got, want)
    if variant == "wrap":
        assert (got[::2] < 0).any()
