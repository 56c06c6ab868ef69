"""Kernels K5-K8 of the port against the JAX package (CPU).

The port's plain versions, and its wrappers on CPU tensors (which run the
plain versions), are held EXACTLY equal to ``repro``'s Pallas kernels,
run by the interpreter as ``tests/test_kernels.py`` runs them, and to the
``ref.py`` oracles, on the shapes of that file plus the hazards of the
port:

* ``gap_decode`` (K6): the six shapes and the cross-tile carry, ``firsts``
  as (R,) and as (R, 1), sums that wrap past 2**31 - 1;
* ``bitmap_and`` (K8): the four sizes, the set semantics over
  ``core.bitmaps``, ``bitmap_and_count``'s total;
* ``bucket_intersect`` (K7): the four (NB, CAP), rows that are unsorted
  and hold duplicates and interior ``INT_INF``, shapes that are no tile
  multiple, ``bucketize`` / ``unbucketize`` equal to ``repro``'s;
* ``grammar_expand`` (K5): a real grammar against the ref and the host
  expansion, terminals only, a ``max_depth`` cut short of the grammar's
  depth, W and S that are no tile multiple; and hand-made tables: lens
  that disagree with the children's, phrases of 33-64 gaps cut at 32, a
  cut at every depth from 0 to ``max_depth``, ids -1, S and S + 5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.jax_index import build_flat_index as build_flat_index_jax
from repro.core.repair import repair_compress as repair_compress_jax
from repro.kernels.bitmap_and.ops import bitmap_and as bitmap_and_jax
from repro.kernels.bitmap_and.ops import \
    bitmap_and_count as bitmap_and_count_jax
from repro.kernels.bitmap_and.ref import bitmap_and_count_ref, bitmap_and_ref
from repro.kernels.bucket_intersect.ops import \
    bucket_intersect as bucket_intersect_jax
from repro.kernels.bucket_intersect.ops import bucketize as bucketize_jax
from repro.kernels.bucket_intersect.ops import unbucketize as unbucketize_jax
from repro.kernels.bucket_intersect.ref import bucket_intersect_ref
from repro.kernels.gap_decode.ops import gap_decode as gap_decode_jax
from repro.kernels.gap_decode.ref import gap_decode_ref
from repro.kernels.grammar_expand.ops import \
    grammar_expand as grammar_expand_jax
from repro.kernels.grammar_expand.ref import grammar_expand_ref

from repro_torch.core.bitmaps import build_bitmap
from repro_torch.core.index import flat_index_arrays
from repro_torch.core.repair import repair_compress
from repro_torch.kernels import KERNELS
from repro_torch.kernels.bitmap_and import (bitmap_and, bitmap_and_count,
                                            bitmap_and_count_plain,
                                            bitmap_and_plain, popcount32)
from repro_torch.kernels.bucket_intersect import (INT_INF, bucket_intersect,
                                                  bucket_intersect_plain,
                                                  bucketize, unbucketize)
from repro_torch.kernels.gap_decode import gap_decode, gap_decode_plain
from repro_torch.kernels.grammar_expand import (PHRASE_CAP, TILE_W,
                                                grammar_expand,
                                                grammar_expand_plain)

INF = int(INT_INF)
T = torch.from_numpy


def test_registry_covers_eight_kernels():
    assert KERNELS[4:] == ("grammar_expand", "gap_decode", "bucket_intersect",
                           "bitmap_and")
    assert len(set(KERNELS)) == 8


# -- gap_decode (K6) -----------------------------------------------------------

def _gap_port(gaps, firsts):
    """The port's wrapper and plain version on the same CPU tensors."""
    got = gap_decode(T(gaps), T(firsts))
    assert got.dtype == torch.int32
    assert torch.equal(got, gap_decode_plain(T(gaps), T(firsts)))
    return got.numpy()


@pytest.mark.parametrize("firsts_2d", [False, True], ids=["R", "Rx1"])
@pytest.mark.parametrize("shape", [(1, 7), (3, 130), (8, 512), (5, 700),
                                   (16, 1024), (2, 2000)])
def test_gap_decode_shapes(shape, firsts_2d):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    R, C = shape
    gaps = rng.integers(0, 1000, size=(R, C)).astype(np.int32)
    firsts = rng.integers(0, 100, size=(R,)).astype(np.int32)
    if firsts_2d:
        firsts = firsts[:, None].copy()
    got = _gap_port(gaps, firsts)
    np.testing.assert_array_equal(
        got, np.asarray(gap_decode_jax(jnp.asarray(gaps), jnp.asarray(firsts))))
    np.testing.assert_array_equal(got, np.asarray(gap_decode_ref(
        jnp.asarray(gaps), jnp.asarray(firsts).reshape(R, 1))))


def test_gap_decode_cross_tile_carry():
    gaps = np.ones((8, 1537), dtype=np.int32)
    firsts = np.zeros(8, dtype=np.int32)
    got = _gap_port(gaps, firsts)
    np.testing.assert_array_equal(got[0], np.arange(1, 1538))
    np.testing.assert_array_equal(
        got, np.asarray(gap_decode_jax(jnp.asarray(gaps), jnp.asarray(firsts))))


def test_gap_decode_int32_wrap():
    """Sums past 2**31 - 1 wrap as JAX's int32 cumsum does."""
    rng = np.random.default_rng(4)
    gaps = rng.integers(2**28, 2**30, size=(6, 300)).astype(np.int32)
    gaps[2] = -gaps[2]                               # wraps downwards too
    firsts = np.array([2**31 - 5, 0, -2**31, 7, 2**30, -1], np.int32)
    got = _gap_port(gaps, firsts)
    want = (np.cumsum(gaps.astype(np.int64), 1) + firsts[:, None]
            ).astype(np.uint32).view(np.int32)       # mod 2**32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(gap_decode_jax(jnp.asarray(gaps), jnp.asarray(firsts))))
    assert (got[0, 1:] != got[0, :-1]).all() and (got[0] < 0).any()


def test_gap_decode_refuses_bad_operands():
    g = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="firsts"):
        gap_decode(g, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        gap_decode(g.long(), torch.zeros(3, dtype=torch.int32))
    assert gap_decode(torch.zeros((0, 5), dtype=torch.int32),
                      torch.zeros(0, dtype=torch.int32)).shape == (0, 5)


# -- bitmap_and (K8) -----------------------------------------------------------

def _and_port(a, b):
    """The port's two wrappers and plain versions on the same CPU tensors:
    (AND, total)."""
    w = bitmap_and(T(a), T(b))
    w2, total = bitmap_and_count(T(a), T(b))
    pw, ptotal = bitmap_and_count_plain(T(a), T(b))
    assert w.dtype == torch.uint32 and total.dtype == torch.int32
    assert total.shape == ()
    for x in (w2, pw, bitmap_and_plain(T(a), T(b))):
        assert torch.equal(x.view(torch.int32), w.view(torch.int32))
    assert int(total) == int(ptotal)
    return w.numpy(), int(total)


@pytest.mark.parametrize("n", [128, 1024, 4096, 5000])
def test_bitmap_and_sizes(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
    got, total = _and_port(a, b)
    np.testing.assert_array_equal(got, a & b)
    np.testing.assert_array_equal(
        got, np.asarray(bitmap_and_jax(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, np.asarray(bitmap_and_ref(jnp.asarray(a), jnp.asarray(b))))
    anded, cnt = bitmap_and_count_jax(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got, np.asarray(anded))
    assert total == int(cnt) == int(bitmap_and_count_ref(jnp.asarray(a),
                                                         jnp.asarray(b)))
    assert total == int(np.unpackbits((a & b).view(np.uint8)).sum())


def test_bitmap_and_popcount_semantics():
    """The AND of two bitmaps of the port's ``core.bitmaps`` intersects the
    encoded sets, and the total is the intersection's size."""
    rng = np.random.default_rng(21)
    u = 4096
    s1 = np.sort(rng.choice(u, size=700, replace=False))
    s2 = np.sort(rng.choice(u, size=900, replace=False))
    b1 = build_bitmap(s1, u).words.view(np.uint32)
    b2 = build_bitmap(s2, u).words.view(np.uint32)
    got, total = _and_port(b1, b2)
    bits = np.unpackbits(got.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(np.nonzero(bits[:u])[0],
                                  np.intersect1d(s1, s2))
    assert total == np.intersect1d(s1, s2).size
    np.testing.assert_array_equal(
        got, np.asarray(bitmap_and_jax(jnp.asarray(b1), jnp.asarray(b2))))


def test_bitmap_and_count_edges():
    """All-ones and all-zero words, one word, no word, and the SWAR
    popcount of every bit pattern class."""
    ones = np.full(777, 0xFFFFFFFF, np.uint32)
    got, total = _and_port(ones, ones)
    assert total == 777 * 32
    _, cnt = bitmap_and_count_jax(jnp.asarray(ones), jnp.asarray(ones))
    assert total == int(cnt)
    assert _and_port(ones, np.zeros(777, np.uint32))[1] == 0
    assert _and_port(ones[:1], ones[:1])[1] == 32
    got, total = _and_port(np.zeros(0, np.uint32), np.zeros(0, np.uint32))
    assert got.shape == (0,) and total == 0
    w = np.array([0, 1, 0x80000000, 0x55555555, 0xAAAAAAAA, 0xF0F0F0F0,
                  0xFFFFFFFF, 0x7FFFFFFF], np.uint32)
    np.testing.assert_array_equal(popcount32(T(w)).numpy(),
                                  [0, 1, 1, 16, 16, 16, 32, 31])


def test_bitmap_and_refuses_int32():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint32"):
        bitmap_and(a, a)
    u = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError, match="shape"):
        bitmap_and_count(u, u[:4])


# -- bucket_intersect (K7) -----------------------------------------------------

def _bi_port(a, b):
    got = bucket_intersect(T(a), T(b))
    assert got.dtype == torch.int32
    assert torch.equal(got, bucket_intersect_plain(T(a), T(b)))
    return got.numpy()


def _bi_check(a, b):
    """The port == repro's Pallas kernel == the ref oracle == the set
    semantics per row; returns the port's output."""
    got = _bi_port(a, b)
    np.testing.assert_array_equal(
        got, np.asarray(bucket_intersect_jax(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, np.asarray(bucket_intersect_ref(jnp.asarray(a), jnp.asarray(b))))
    for r in range(a.shape[0]):
        av, bv = a[r][a[r] != INF], b[r][b[r] != INF]
        np.testing.assert_array_equal(np.unique(got[r][got[r] != INF]),
                                      np.intersect1d(av, bv))
    return got


@pytest.mark.parametrize("nb,cap", [(8, 128), (16, 128), (8, 256), (32, 128)])
def test_bucket_intersect_shapes(nb, cap):
    rng = np.random.default_rng(nb * 1000 + cap)

    def mk():
        m = np.full((nb, cap), INF, dtype=np.int32)
        for r in range(nb):
            n = int(rng.integers(0, cap))
            vals = np.sort(rng.choice(10000, size=n, replace=False))
            m[r, :n] = vals + r * 10000
        return m
    _bi_check(mk(), mk())


@pytest.mark.parametrize("nb,cap", [(5, 37), (3, 200), (1, 1), (9, 130)])
def test_bucket_intersect_unsorted_duplicates(nb, cap):
    """Rows in any order, with duplicates on both sides and INT_INF among
    the values: exact and position-stable, at no tile multiple."""
    rng = np.random.default_rng(nb * 31 + cap)
    a = rng.integers(0, 40, size=(nb, cap)).astype(np.int32)
    b = rng.integers(0, 40, size=(nb, cap)).astype(np.int32)
    a[rng.random((nb, cap)) < 0.15] = INF
    b[rng.random((nb, cap)) < 0.15] = INF
    got = _bi_check(a, b)
    for r in range(nb):
        hit = (a[r] != INF) & np.isin(a[r], b[r])
        np.testing.assert_array_equal(got[r], np.where(hit, a[r], INF))
    if cap > 40:                          # the rows really are adversarial
        assert (np.diff(a[0]) < 0).any() and np.unique(a[0]).size < cap


def test_bucketize_matches_repro():
    rng = np.random.default_rng(8)
    for universe, kbits, n in ((5000, 7, 900), (70000, 9, 4000), (300, 3, 60)):
        ids = np.sort(rng.choice(universe, size=n, replace=False))
        for cap in (None, 512):
            got = bucketize(ids, universe, kbits, cap)
            np.testing.assert_array_equal(
                got, bucketize_jax(ids, universe, kbits, cap))
            np.testing.assert_array_equal(unbucketize(got), ids)
            np.testing.assert_array_equal(unbucketize(got),
                                          unbucketize_jax(got))
    with pytest.raises(ValueError, match="exceeds cap"):
        bucketize(np.arange(300), 300, 8, cap=128)


def test_bucketized_lists_intersect():
    """Two bucketized posting lists: the kernel's rows unbucketize to the
    lists' intersection."""
    rng = np.random.default_rng(13)
    u, kbits = 20000, 7
    x = np.sort(rng.choice(u, size=3000, replace=False))
    y = np.sort(rng.choice(u, size=5000, replace=False))
    a, b = bucketize(x, u, kbits, 128), bucketize(y, u, kbits, 128)
    got = _bi_check(a, b)
    np.testing.assert_array_equal(unbucketize(got), np.intersect1d(x, y))


# -- grammar_expand (K5) -------------------------------------------------------

@pytest.fixture(scope="module")
def grammar(lists):
    """The flat grammar tables of the conftest lists (400 rules) from
    repro's index, checked equal to the port's own."""
    fi = build_flat_index_jax(repair_compress_jax(lists, max_rules=400))
    tabs = [np.asarray(t) for t in (fi.sym_left, fi.sym_right, fi.sym_sum,
                                    fi.sym_len)]
    arrays, statics = flat_index_arrays(repair_compress(lists, max_rules=400))
    for t, k in zip(tabs, ("sym_left", "sym_right", "sym_sum", "sym_len")):
        np.testing.assert_array_equal(t, arrays[k])
    assert statics["max_depth"] == fi.max_depth
    return tabs, fi.max_depth, fi.num_terminals


def _expand(syms, tabs, max_depth, pallas=True, ref=True):
    """The port's wrapper and plain version == repro's ref and its
    interpreted Pallas kernel (each unless switched off)."""
    args = [T(np.array(x, np.int32)) for x in (syms, *tabs)]
    got = grammar_expand(*args, max_depth=max_depth)
    assert got.dtype == torch.int32 and got.shape == (len(syms), PHRASE_CAP)
    assert torch.equal(got, grammar_expand_plain(*args, max_depth=max_depth))
    got = got.numpy()
    jargs = [jnp.asarray(np.asarray(x, np.int32)) for x in (syms, *tabs)]
    if ref:
        np.testing.assert_array_equal(got, np.asarray(grammar_expand_ref(
            *jargs, max_depth=max_depth, phrase_cap=PHRASE_CAP)))
    if pallas:
        np.testing.assert_array_equal(got, np.asarray(grammar_expand_jax(
            *jargs, max_depth=max_depth)))
    return got


def _depths(left, right):
    """Rule depth of every symbol (terminals 0): children precede their
    rule in the dense order, so one pass in id order suffices."""
    d = np.zeros(left.size, np.int64)
    for s in np.nonzero(left >= 0)[0]:
        d[s] = 1 + max(d[left[s]], d[right[s]])
    return d


def _host_expand(s, left, right, sums):
    """The gaps of symbol ``s`` by a stack walk of the tables."""
    stack, want = [int(s)], []
    while stack:
        t = stack.pop()
        if left[t] < 0:
            want.append(int(sums[t]))
        else:
            stack.append(int(right[t]))
            stack.append(int(left[t]))
    return want


def test_grammar_expand_vs_ref_and_truth(grammar):
    tabs, max_depth, _ = grammar
    left, right, sums, lens = tabs
    cand = np.nonzero(lens <= PHRASE_CAP)[0]
    syms = cand[: (cand.size // 16) * 16][:64].astype(np.int32)
    rules = cand[cand >= grammar[2]][:48].astype(np.int32)
    syms = np.concatenate([syms, rules])
    got = _expand(syms, tabs, max_depth)
    for w, s in enumerate(syms):
        want = _host_expand(s, left, right, sums)
        np.testing.assert_array_equal(got[w][:len(want)], want)
        assert (got[w][len(want):] == 0).all()


def test_grammar_expand_terminals_only():
    rng = np.random.default_rng(5)
    S = 64
    tabs = (np.full(S, -1, np.int32), np.full(S, -1, np.int32),
            np.arange(S, dtype=np.int32), np.ones(S, np.int32))
    syms = rng.integers(0, S, size=16).astype(np.int32)
    got = _expand(syms, tabs, 4)
    np.testing.assert_array_equal(got[:, 0], syms)
    assert (got[:, 1:] == 0).all()


@pytest.mark.parametrize("cut", [0, 1, 2, "half"])
def test_grammar_expand_max_depth_cut_short(grammar, cut):
    """A ``max_depth`` below the grammar's depth: lanes still on a rule
    output that rule's sum, as in the reference — no lane runs further."""
    tabs, max_depth, _ = grammar
    depth = max_depth // 2 if cut == "half" else cut
    d = _depths(tabs[0], tabs[1])
    deep = np.nonzero((tabs[3] <= PHRASE_CAP) & (d > depth))[0]
    assert depth < max_depth and deep.size
    syms = deep[np.argsort(-d[deep], kind="stable")][:32].astype(np.int32)
    got = _expand(syms, tabs, depth)
    full = _expand(syms, tabs, max_depth, pallas=False)
    assert (got != full).any(axis=1).all()        # every row was cut


def test_grammar_expand_any_w_and_s(grammar):
    """W and S that are no multiple of the reference's tiles (TILE_W, 128):
    the tables cut to S (a rule's children precede it, so the cut grammar
    is whole), and symbol ids in the reference's padded slots
    ``[S, S_pad)``, which expand to a zero row as there."""
    tabs, max_depth, T_ = grammar
    S = int(tabs[0].size) - 3
    S -= (S % 128 == 0)
    keep = [t[:S].copy() for t in tabs]
    assert (keep[0] < S).all() and (keep[1] < S).all() and S > T_
    S_pad = -(-S // 128) * 128
    W = 3 * TILE_W + 5
    syms = np.random.default_rng(9).integers(0, S, size=W).astype(np.int32)
    got = _expand(syms, keep, max_depth)
    assert got.shape == (W, PHRASE_CAP) and S % 128 and W % TILE_W
    pad = np.array([S, S + 1, S_pad - 1], np.int32)
    assert (_expand(pad, keep, max_depth, ref=False) == 0).all()


def test_grammar_expand_refuses_bad_operands(grammar):
    tabs, max_depth, _ = grammar
    t = [T(np.array(x)) for x in tabs]
    with pytest.raises(ValueError, match="share one"):
        grammar_expand(torch.zeros(4, dtype=torch.int32), t[0], t[1][:-1],
                       t[2], t[3], max_depth=max_depth)
    with pytest.raises(ValueError, match="max_depth"):
        grammar_expand(torch.zeros(4, dtype=torch.int32), *t, max_depth=-1)


def _hand_tables():
    """Terminals 0-7; a left-deep chain of rules (depth 7, 8 gaps), a rule
    over it, and rules of 16, 25, 32, 33, 41, 57 and 64 gaps built from
    them.  Every table entry is consistent: lens and sums are the
    children's totals.  Returns the four int32 tables, the rules of 33-64
    gaps and the grammar's depth."""
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
    d = rule(c, a)
    e = rule(a, a)
    f = rule(e, 5)
    g = rule(e, e)
    tabs = tuple(np.asarray(t, np.int32) for t in (left, right, sums, lens))
    depth = int(_depths(tabs[0], tabs[1]).max())
    assert [lens[r] for r in (c, d, f, g)] == [41, 57, 33, 64]
    return tabs, np.asarray([c, d, f, g], np.int32), depth


def test_grammar_expand_long_phrases_cut_at_32():
    """Phrases of 33-64 gaps: the row holds the first 32, as in the
    reference; the shorter rules' rows end in zeros."""
    tabs, long_rules, depth = _hand_tables()
    left, right, sums, lens = tabs
    syms = np.concatenate([long_rules, np.arange(lens.size, dtype=np.int32)])
    got = _expand(syms, tabs, depth)
    for w, s in enumerate(syms):
        want = _host_expand(s, left, right, sums)
        n = min(len(want), PHRASE_CAP)
        np.testing.assert_array_equal(got[w][:n], want[:n])
        assert (got[w][n:] == 0).all()


def test_grammar_expand_every_depth():
    """A cut at every depth from 0 to the grammar's: the reference's
    output at each, for every symbol."""
    tabs, _, depth = _hand_tables()
    syms = np.arange(tabs[0].size, dtype=np.int32)
    rows = [_expand(syms, tabs, d) for d in range(depth + 1)]
    assert all((a != b).any() for a, b in zip(rows, rows[1:]))


def test_grammar_expand_lens_disagree():
    """lens that disagree with the children's (smaller, larger, zero,
    negative, INT_MAX and INT_MIN, wants that wrap): the reference's
    per-slot descent, whatever the tables say."""
    tabs, long_rules, depth = _hand_tables()
    left, right, sums, lens = (t.copy() for t in tabs)
    rng = np.random.default_rng(18)
    odd = rng.choice(lens.size, size=lens.size // 2, replace=False)
    lens[odd] = rng.choice(np.array([-7, 0, 1, 2, 5, 31, 33, 40, 2**31 - 1,
                                     -2**31, -2**31 + 3], np.int64),
                           size=odd.size).astype(np.int32)
    syms = np.concatenate([np.arange(lens.size), long_rules]).astype(np.int32)
    for d in (depth, 3, 0):
        _expand(syms, (left, right, sums, lens), d)


def test_grammar_expand_ids_outside_the_tables():
    """Ids -1, S and S + 5 beside real ones: a zero row, as the
    reference's padded slots give (repro's ref clamps such ids, so only
    its Pallas kernel is held here)."""
    tabs, _, depth = _hand_tables()
    S = tabs[0].size
    syms = np.array([-1, S, 3, S + 5, S - 1, -1], np.int32)
    got = _expand(syms, tabs, depth, ref=False)
    assert not got[[0, 1, 3, 5]].any() and got[[2, 4]].any()
