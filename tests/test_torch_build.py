"""The port's construction pipeline against the JAX package's (CPU).

The same postings go through ``repro.build`` (host, jnp, and pallas in
interpret mode) and ``repro_torch.build`` (host, torch, and cuda with
``device="cpu"``, where the ``pair_count`` kernel's plain version
counts).  Every grammar must be bit-identical — rules, phrase sums,
lengths, depths, the compressed stream and the span table — on every
configuration of ``tests/test_build.py``, under budget growth and the
rank-table fallback, round by round through the round-level API, and on a
Zipf corpus at the [CN07] capped-counting configuration the cuda builder
runs with (``table_cap=4096``).  ``build_index`` products (FlatIndex /
PagedIndex tensors, the index builder's ``InvertedIndex``) equal
``repro``'s arrays.
"""

import numpy as np
import pytest
import torch

from strategies import HAVE_HYPOTHESIS, small_lists
from test_build import CONFIGS, assert_same_result

from repro.build import make_builder as make_builder_jax
from repro.core.jax_index import build_flat_index as flat_jax
from repro.core.jax_index import build_paged_index as paged_jax
from repro.core.repair import repair_compress as repair_jax
from repro.index import build_index as build_index_jax

from repro_torch import kernels as KR
from repro_torch.build import (BUILDERS, CudaBuilder, HostBuilder,
                               TorchBuilder, make_builder,
                               validate_builders)
from repro_torch.core.index import _FLAT_ARRAYS, _PAGED_ARRAYS
from repro_torch.index import build_index
from repro_torch.index.corpus import zipf_corpus

DEVICE_BUILDERS = ("torch", "cuda")


def _port(name, **cfg):
    return make_builder(name, device="cpu", **cfg)


def _decodes(res, lists):
    for i, want in enumerate(lists):
        np.testing.assert_array_equal(res.decode_list(i), want)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_torch_builder_bit_parity(cfg):
    """Every config of test_build: the port's torch builder == repro's
    host and jnp builders."""
    lists = small_lists()
    host = make_builder_jax("host", **cfg).build_grammar(lists)
    assert_same_result(host, make_builder_jax("jnp", **cfg)
                       .build_grammar(lists))
    dev = _port("torch", **cfg).build_grammar(lists)
    assert_same_result(host, dev)
    _decodes(dev, lists)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_cuda_builder_bit_parity(cfg):
    """Every config of test_build, at its pallas table size: the port's
    cuda builder (K4's plain version on the CPU) == repro's host."""
    lists = small_lists(seed=3, n_lists=8, universe=400, max_len=70)
    host = make_builder_jax("host", **cfg).build_grammar(lists)
    dev = _port("cuda", pair_table=512, **cfg).build_grammar(lists)
    assert_same_result(host, dev)
    _decodes(dev, lists)


def test_cuda_builder_matches_pallas_interpret():
    """test_build's small pallas config: the port's cuda builder == repro's
    PallasBuilder run by the Pallas interpreter."""
    lists = small_lists(seed=3, n_lists=8, universe=400, max_len=70)
    ref = make_builder_jax("pallas", pair_table=512,
                           interpret=True).build_grammar(lists)
    assert_same_result(ref, _port("cuda", pair_table=512)
                       .build_grammar(lists))


def test_host_builder_is_repair_compress():
    lists = small_lists(seed=1)
    assert_same_result(HostBuilder().build_grammar(lists), repair_jax(lists))


def test_parity_on_shared_corpus(lists):
    """The conftest corpus (the one every other suite uses); uncapped, its
    first round has more distinct pairs than the default 4096-slot
    candidate table, so the cuda builder gets a larger one."""
    ref = make_builder_jax("jnp").build_grammar(lists)
    assert_same_result(ref, _port("torch").build_grammar(lists))
    assert_same_result(ref, _port("cuda", pair_table=8192)
                       .build_grammar(lists))


@pytest.mark.parametrize("budget", [4, 8])
@pytest.mark.parametrize("name", DEVICE_BUILDERS)
def test_budget_growth_parity(name, budget):
    """A tiny starting rule budget forces the doubling path, as
    REPRO_RULE_BUDGET=8 does in CI."""
    lists = small_lists(seed=2)
    bld = _port(name, rule_budget=budget)
    assert_same_result(make_builder_jax("jnp", rule_budget=budget)
                       .build_grammar(lists), bld.build_grammar(lists))
    assert bld.stats["growths"] >= 2


def test_rank_table_fallback_parity():
    """A degenerate rank table forces the exact full-length redo."""
    lists = small_lists(seed=4)
    bld = _port("torch")
    bld._rank_k = lambda: 2
    assert_same_result(make_builder_jax("host").build_grammar(lists),
                       bld.build_grammar(lists))
    assert bld.stats["fallbacks"] > 0


def test_round_level_api_matches_jnp():
    """count_pairs/replace_round agree with repro's JnpBuilder (and host)
    round by round, and so do the logical sequences."""
    lists = small_lists(seed=5, n_lists=6, universe=300, max_len=50)
    cfg = dict(pairs_per_round=4, min_count=2)
    ref = make_builder_jax("jnp", **cfg)
    host = make_builder_jax("host", **cfg)
    bld = _port("torch", **cfg)
    rs, hs, ps = ref.init_state(lists), host.init_state(lists), \
        bld.init_state(lists)
    assert ps[1]["T"] == rs[1]["T"] == hs.num_terminals
    for rnd in range(4):
        rp, rc = ref.count_pairs(rs)
        pp, pc = bld.count_pairs(ps)
        np.testing.assert_array_equal(rp, pp)
        np.testing.assert_array_equal(rc, pc)
        np.testing.assert_array_equal(host.count_pairs(hs)[0], pp)
        if not len(rp):
            break
        chosen = rp[:2]
        new_ids = hs.num_terminals + 100 + np.arange(len(chosen))
        rs, rcnt = ref.replace_round(rs, chosen, new_ids)
        ps, pcnt = bld.replace_round(ps, chosen, new_ids)
        hs, _ = host.replace_round(hs, chosen, new_ids)
        np.testing.assert_array_equal(rcnt, pcnt)
        want = np.asarray(rs[0].seq)[np.asarray(rs[0].real)]
        got = ps[0].seq[ps[0].real].numpy()
        np.testing.assert_array_equal(want, got)
        np.testing.assert_array_equal(hs.seq[hs.active], got)
    with pytest.raises(ValueError, match="contiguous ids"):
        bld.replace_round(ps, rp[:2], np.asarray([900, 905]))


def test_zipf_corpus_capped_parity():
    """A ~600-doc Zipf corpus at the cuda builder's configuration
    (table_cap=4096, 64 pairs per round): budget growth and compaction
    both happen, and all builders agree with repro's host builder."""
    lists = zipf_corpus(num_docs=600, vocab_size=600, mean_doc_len=120,
                        seed=0).postings()
    cfg = dict(table_cap=4096, pairs_per_round=64)
    host = make_builder_jax("host", **cfg).build_grammar(lists)
    for name in DEVICE_BUILDERS:
        bld = _port(name, **cfg)
        res = bld.build_grammar(lists)
        assert_same_result(host, res)
        assert bld.stats["growths"] >= 1 and bld.stats["compactions"] >= 1
    _decodes(res, lists)


def test_pair_count_launched_once_per_round(monkeypatch):
    """The cuda builder counts every round with K4's wrapper (on the CPU
    its plain version), once per round, on the [CN07] candidate table."""
    from repro_torch.build import cuda_builder
    calls = []
    real = cuda_builder.pair_count

    def counting(ca, cb, *rest):
        calls.append(int(ca.shape[0]))
        return real(ca, cb, *rest)

    monkeypatch.setattr(cuda_builder, "pair_count", counting)
    bld = _port("cuda", table_cap=600)
    res = bld.build_grammar(small_lists(seed=9, n_lists=12, universe=600,
                                        max_len=100))
    assert len(calls) == bld.stats["rounds"] > 1
    assert set(calls) == {640}                 # Kp: 600 rounded to 128
    assert res.grammar.num_rules > 0


def test_partial_candidate_tile_parity():
    """A cap that is a 128- but not a 512-multiple (600 -> Kp = 640)."""
    lists = small_lists(seed=9, n_lists=12, universe=600, max_len=100)
    assert_same_result(make_builder_jax("host", table_cap=600)
                       .build_grammar(lists),
                       _port("cuda", table_cap=600).build_grammar(lists))


def test_uncapped_table_overflow_raises():
    lists = small_lists(seed=6)
    with pytest.raises(RuntimeError, match="candidate table"):
        _port("cuda", pair_table=128).build_grammar(lists)


@pytest.mark.parametrize("name", DEVICE_BUILDERS)
def test_symbol_space_guard(name):
    bld = _port(name, rule_budget=2**16)
    with pytest.raises(ValueError, match="symbol space"):
        # gaps up to ~50000 -> num_terminals alone near the packing cap
        bld.build_grammar([np.asarray([0, 50000]), np.asarray([1, 49999])])


@pytest.mark.parametrize("name", DEVICE_BUILDERS)
def test_single_element_and_identical_lists(name):
    cases = [
        [np.asarray([5]), np.asarray([0]), np.asarray([999])],
        [np.asarray([3, 7, 20, 21, 50, 90, 91, 120])] * 4,
        [np.arange(1, 40, 3), np.arange(0, 120, 7)],
    ]
    for lists in cases:
        dev = _port(name).build_grammar(lists)
        assert_same_result(make_builder_jax("host").build_grammar(lists), dev)
        _decodes(dev, lists)


@pytest.mark.parametrize("name", ["host", "torch", "cuda"])
def test_build_index_end_to_end(name):
    """Postings -> grammar -> FlatIndex/PagedIndex through one call: every
    tensor equals repro's array for the same postings."""
    lists = small_lists(seed=7)
    built = _port(name).build_index(lists, B=4, paged=True, page_size=128)
    assert built.pi is not None and built.pi.flat is built.fi
    assert built.fi.device == torch.device("cpu")
    fi_j = flat_jax(make_builder_jax("jnp").build_grammar(lists), B=4)
    pi_j = paged_jax(fi_j, 128)
    for k in _FLAT_ARRAYS:
        np.testing.assert_array_equal(getattr(built.fi, k).numpy(),
                                      np.asarray(getattr(fi_j, k)), k)
    for k in ("num_terminals", "max_depth", "max_scan", "universe"):
        assert getattr(built.fi, k) == getattr(fi_j, k), k
    for k in _PAGED_ARRAYS:
        np.testing.assert_array_equal(getattr(built.pi, k).numpy(),
                                      np.asarray(getattr(pi_j, k)), k)


def test_build_index_optimize_matches_repro():
    lists = small_lists(seed=8)
    got = _port("torch").build_index(lists, optimize=True).res
    want = make_builder_jax("jnp").build_index(lists, optimize=True).res
    assert_same_result(want, got)


@pytest.mark.parametrize("hybrid", [False, True])
def test_index_builder_matches_repro(hybrid):
    """``index.build_index`` routes builders by name; its Re-Pair result,
    samplings and space report (codecs, bitmaps, dictionary) equal
    repro's."""
    lists = small_lists(seed=8, n_lists=6)
    want = build_index_jax(lists, builder="host", hybrid_bitmaps=hybrid)
    for name in ("host", "torch", "cuda"):
        got = build_index(lists, builder=name, device="cpu",
                          hybrid_bitmaps=hybrid)
        assert_same_result(want.repair, got.repair)
        assert got.space_report() == want.space_report()
        assert got.bitmap_idx == want.bitmap_idx
        assert got.b_samp.kbits == want.b_samp.kbits
        for a, b in zip(got.b_samp.abs_before, want.b_samp.abs_before):
            np.testing.assert_array_equal(a, b)
        # both honour REPRO_STORE alike (no store unless it is set)
        assert (got.page_store is None) == (want.page_store is None)


def test_index_builder_refuses_store(monkeypatch):
    """``store=`` builds the page store (the name is kept from when the
    port refused it): ``mmap`` writes the paged stream to disk,
    ``REPRO_STORE=memory`` attaches an in-memory store, ``none`` opts
    out, and an unknown kind raises ``ValueError`` — with the same pages
    as the JAX package's store."""
    lists = small_lists(seed=8, n_lists=4)
    got = build_index(lists, store="mmap", page_size=128, device="cpu")
    want = build_index_jax(lists, store="mmap", page_size=128)
    assert got.page_store.kind == "mmap" and got.page_store.disk_bytes > 0
    pages = np.arange(got.page_store.num_pages)
    for a, b in zip(got.page_store.gather(pages),
                    want.page_store.gather(pages)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("REPRO_STORE", "memory")
    assert build_index(lists, device="cpu").page_store.kind == "memory"
    assert build_index(lists, store="none", device="cpu").page_store is None
    with pytest.raises(ValueError, match="unknown page store kind"):
        build_index(lists, store="tape", device="cpu")
    with pytest.raises(ValueError, match="build_cfg"):
        build_index(lists, max_rules=3, build_cfg=None,
                    builder=_port("host"), store="none")


def test_validate_builders():
    assert set(BUILDERS) == {"host", "torch", "cuda"}
    validate_builders(BUILDERS)
    with pytest.raises(ValueError, match="unknown builder"):
        validate_builders(["torch", "jnp"])
    with pytest.raises(ValueError, match="unknown builder"):
        make_builder("pallas")
    assert isinstance(_port("torch"), TorchBuilder)
    assert isinstance(_port("cuda"), CudaBuilder)
    assert _port("cuda", table_cap=4096)._Kp == 4096
    assert _port("cuda")._Kp == 4096 and _port("cuda", pair_table=1)._Kp == 128


def test_device_builders_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in DEVICE_BUILDERS:
        with pytest.raises(RuntimeError, match="is_available"):
            make_builder(name)
        assert _port(name).device == torch.device("cpu")
    host = make_builder("host")              # builds on the host anyway
    with pytest.raises(RuntimeError, match="is_available"):
        host.build_index(small_lists(seed=1))
    assert KR.resolve_device("cpu") == torch.device("cpu")


if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st
    from strategies import posting_lists

    @settings(max_examples=15, deadline=None)
    @given(posting_lists(max_lists=6, max_universe=400, max_len=60),
           st.sampled_from([1, 4, 64]), st.sampled_from([0, 32]))
    def test_device_roundtrip_property(lists, ppr, cap):
        """Port device grammars decode back to the input and match the
        host grammar bit for bit, for arbitrary lists and configs."""
        host = make_builder_jax("host", pairs_per_round=ppr,
                                table_cap=cap).build_grammar(lists)
        for name in DEVICE_BUILDERS:
            dev = _port(name, pairs_per_round=ppr, table_cap=cap,
                        pair_table=2048).build_grammar(lists)
            assert_same_result(host, dev)
            _decodes(dev, lists)
