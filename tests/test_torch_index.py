"""Index parity between the port (``repro_torch``) and the JAX package.

The host Re-Pair grammar, the (b)-sampling, every array of the flat,
paged and score indexes, and the [BY04] prefix table must be exactly the
JAX package's on the same postings; the ``*_from_arrays`` builders must
carry one package's state into the other unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from strategies import adversarial_lists, make_lists

from repro.core import jax_index as JI
from repro.core.repair import repair_compress as repair_jax
from repro.core.sampling import build_b_sampling as bsamp_jax
from repro.engine import jnp_backend as JB

from repro_torch.core import index as TI
from repro_torch.core.repair import (repair_compress, repair_result_from_arrays,
                                     repair_result_to_arrays)
from repro_torch.core.sampling import build_b_sampling
from repro_torch.engine import torch_backend as TB

CPU = torch.device("cpu")


def _corpora():
    return {"make_lists": make_lists(np.random.default_rng(12345)),
            "adversarial": adversarial_lists(np.random.default_rng(7))}


@pytest.fixture(scope="module", params=["make_lists", "adversarial"])
def pair(request):
    """(lists, repro result, port result) for one corpus."""
    lists = _corpora()[request.param]
    return lists, repair_jax(lists), repair_compress(lists)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_grammar_identical(pair):
    _, rj, rt = pair
    for f in ("num_terminals",):
        assert getattr(rj.grammar, f) == getattr(rt.grammar, f)
    for f in ("rules", "sums", "lengths", "depths"):
        np.testing.assert_array_equal(getattr(rj.grammar, f),
                                      getattr(rt.grammar, f))
    for f in ("seq", "starts", "first_values", "orig_lengths"):
        np.testing.assert_array_equal(getattr(rj, f), getattr(rt, f))
    assert rj.universe == rt.universe


def test_b_sampling_identical(pair):
    _, rj, rt = pair
    bj, bt = bsamp_jax(rj, 8), build_b_sampling(rt, 8)
    assert list(bj.kbits) == list(bt.kbits)
    for a, b in zip(bj.c_pos + bj.abs_before, bt.c_pos + bt.abs_before):
        np.testing.assert_array_equal(a, b)


def _assert_same_fields(jax_obj, port_obj):
    for f in dataclasses.fields(port_obj):
        a, b = getattr(jax_obj, f.name), getattr(port_obj, f.name)
        if dataclasses.is_dataclass(b):
            _assert_same_fields(a, b)
        elif isinstance(b, (torch.Tensor, np.ndarray)):
            bn = _np(b)
            an = np.asarray(a)
            assert an.dtype == bn.dtype, f.name
            np.testing.assert_array_equal(an, bn, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("page", [2048, 128])
def test_flat_and_paged_index_identical(pair, page):
    _, rj, rt = pair
    fj = JI.build_flat_index(rj)
    ft = TI.build_flat_index(rt, device=CPU)
    _assert_same_fields(fj, ft)
    for t in vars(ft).values():
        if isinstance(t, torch.Tensor):
            assert t.dtype == torch.int32 and t.device == CPU
    pj = JI.build_paged_index(fj, page_size=page)
    pt = TI.build_paged_index(ft, page_size=page)
    _assert_same_fields(pj, pt)
    assert pj.num_pages == pt.num_pages


@pytest.mark.parametrize("page", [None, 128])
def test_score_index_identical(pair, page):
    _, rj, rt = pair
    _assert_same_fields(JI.build_score_index(rj, page_size=page),
                        TI.build_score_index(rt, page_size=page))


def test_bys_table_identical(pair):
    _, rj, rt = pair
    np.testing.assert_array_equal(
        np.asarray(JB.build_bys_table(JI.build_flat_index(rj))),
        _np(TB.build_bys_table(TI.build_flat_index(rt, device=CPU))))


def test_bm25_helpers_identical(pair):
    lists, _, _ = pair
    df = np.asarray([len(l) for l in lists])
    np.testing.assert_array_equal(JI.bm25_idf(df, 900), TI.bm25_idf(df, 900))
    dl = np.arange(40) % 7
    np.testing.assert_array_equal(JI.bm25_doc_weights(dl, 3.5),
                                  TI.bm25_doc_weights(dl, 3.5))
    assert (TI.INT_INF, TI.BM25_K1, TI.BM25_B, TI.DEFAULT_PAGE) == \
        (JI.INT_INF, JI.BM25_K1, JI.BM25_B, JI.DEFAULT_PAGE)


def test_repair_result_carry_over(pair):
    """A JAX-package result's arrays rebuild an identical port result,
    and the port's own round trip is lossless."""
    _, rj, rt = pair
    arrays = {k: np.asarray(getattr(rj.grammar, k)) for k in
              ("rules", "sums", "lengths", "depths")}
    arrays.update({k: np.asarray(getattr(rj, k)) for k in
                   ("seq", "starts", "first_values", "orig_lengths")})
    carried = repair_result_from_arrays(
        arrays, {"num_terminals": rj.grammar.num_terminals,
                 "universe": rj.universe})
    again = repair_result_from_arrays(*repair_result_to_arrays(rt))
    for res in (carried, again):
        _assert_same_fields(rt.grammar, res.grammar)
        for f in ("seq", "starts", "first_values", "orig_lengths"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(res, f))
        assert res.universe == rt.universe
        for i in range(rt.num_lists):
            np.testing.assert_array_equal(res.decode_list(i),
                                          rt.decode_list(i))


@pytest.mark.parametrize("page", [2048, 128])
def test_index_carry_over(pair, page):
    """The JAX package's paged index, taken as numpy arrays, rebuilds the
    port's paged (and flat) index field for field."""
    _, rj, rt = pair
    pj = JI.build_paged_index(JI.build_flat_index(rj), page_size=page)
    fields = {f.name: np.asarray(getattr(pj.flat, f.name))
              for f in dataclasses.fields(pj.flat)}
    fields.update({k: np.asarray(getattr(pj, k)) for k in
                   ("c_syms_pg", "c_sums_pg", "page_dir", "bck_page",
                    "bck_off")})
    statics = {k: fields.pop(k) for k in
               ("num_terminals", "max_depth", "max_scan", "universe")}
    statics["page_size"] = pj.page_size
    pt = TI.paged_index_from_arrays(fields, statics, CPU)
    _assert_same_fields(pj, pt)
    ft = TI.flat_index_from_arrays(fields, statics, CPU)
    _assert_same_fields(pj.flat, ft)
    own = TI.build_paged_index(TI.build_flat_index(rt, device=CPU), page)
    arrays, st = TI.index_to_arrays(own)
    _assert_same_fields(own, TI.paged_index_from_arrays(arrays, st, CPU))
