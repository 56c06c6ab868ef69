"""The bounds ``chip_smoke.py`` holds the K3, K5 and K7 kernels to.

``k3_traffic``, ``k5_traffic`` and ``k7_traffic`` count the bytes and
operations the function of one launch needs on its inputs, the same for
any kernel; ``k5_layout`` reports what a K5 launch's symbols ask of it.
On inputs small enough to count by hand they must give the hand count.
The smoke script is imported by its path; nothing here needs a card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ef as EF

INF = 2**31 - 1


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k7_traffic_hand_count(smoke):
    """12 bytes a slot; 4 operations per live slot of b and of a, one
    select per slot."""
    a = torch.tensor([[1, INF, 3], [-5, 7, 7]], dtype=torch.int32)
    b = torch.tensor([[3, 3, INF], [INF, INF, INF]], dtype=torch.int32)
    # live: a 2 + 3, b 2 + 0 -> 4 * 7 + 6 slots
    assert smoke.k7_traffic(a, b) == (72.0, 34.0)


def test_k3_traffic_hand_count(smoke):
    """One list [3, 8, 9, 20]: l = 2, highs [0, 2, 2, 5], lows [3, 0, 1,
    0], ones at bits 0, 3, 4, 8 of one 8-word sample page.  The lane x = 9
    (hx 2, xlo 1) takes three selects of 0 bisection trips and 1 page word
    each (11 operations each), a bucket bisection of 2 trips over [1, 3)
    and the answer: 6 + 33 + 16 + 10 = 65; the lanes x = 2 (at or before
    the head) and x = 21 (past the tail) settle in the masks, 6 each.
    Bytes: 12 per lane; 12 of directory for the list, 16 more for it as
    an active list; one select sample, one high-bits word and the two
    low-bits words the field reads reach, 4 bytes each."""
    store = EF.build_ef_store([np.asarray([3, 8, 9, 20])], 32)
    assert int(store.lbits[0]) == 2
    assert int(store.hi_words[0]) == (1 | 1 << 3 | 1 << 4 | 1 << 8)
    rank = store.select_samples()
    pack = EF.ef_device_pack(store, rank, "cpu")
    lids = torch.zeros(3, dtype=torch.int32)
    xs = torch.tensor([9, 2, 21], dtype=torch.int32)
    assert EF.ef_next_geq_torch(pack, lids, xs).tolist() == [9, 3, INF]
    assert smoke.k3_traffic(lids, xs, pack) == (36 + 28 + 16.0, 77.0)


def test_k3_traffic_counts_bisection_and_page_words(smoke):
    """A dense list, 0..599 (l = 0: ones at the even bits, zeros at the
    odd ones, 5 sample pages of 128 ones).  For x = 300 each of the three
    selects (zero 299, zero 300, one 301) bisects the samples in 2 trips
    (mids 2 and 3) to page 2 and popcounts its words 16, 17 and 18: 2 * 6
    + 3 * 3 + 8 = 29 operations each, never the in-word bit scan of one
    design.  The bucket [300, 301) takes one trip: 6 + 87 + 8 + 10 = 111.
    Bytes: 12 for the lane, 28 of directory, samples 0, 2 and 3, high
    words 16-18 and the low region's one guard word, 4 bytes each."""
    store = EF.build_ef_store([np.arange(600)], 600)
    rank = store.select_samples()
    assert int(store.lbits[0]) == 0 and rank.tolist() == [0, 128, 256, 384,
                                                         512, 600]
    pack = EF.ef_device_pack(store, rank, "cpu")
    lid = torch.zeros(1, dtype=torch.int32)
    x = torch.tensor([300], dtype=torch.int32)
    assert EF.ef_next_geq_torch(pack, lid, x).tolist() == [300]
    assert smoke.k3_traffic(lid, x, pack) == (68.0, 111.0)


def _k5_tables(left, right, lens):
    t = lambda a: torch.tensor(a, dtype=torch.int32)
    return dict(sym_left=t(left), sym_right=t(right), sym_len=t(lens))


def test_k5_traffic_hand_count(smoke):
    """Terminals 0, 1, 2; rule 3 = (0, 1) of 2 gaps, rule 4 = (3, 2) of 3.
    Symbols [4, 0, 3] expand to trees of 5, 1 and 3 nodes: 9 nodes, 4
    operations each, plus one per slot of the three (32,) rows.  At
    max_depth 1 rule 4 stops at 3 (its tree is 4, 3, 2) but rule 3 still
    reaches its terminals: 7 nodes.  At max_depth 0 each symbol is its
    own node.  Bytes: 4 a symbol, 128 a row, 16 per distinct node read
    (all five; at max_depth 0 the three symbols); an id outside the
    tables reads nothing and is one node."""
    tabs = _k5_tables([-1, -1, -1, 0, 3], [-1, -1, -1, 1, 2],
                      [1, 1, 1, 2, 3])
    syms = torch.tensor([4, 0, 3], dtype=torch.int32)
    assert smoke.k5_traffic(syms, tabs, 13) == (476.0, 96 + 4 * 9.0)
    assert smoke.k5_traffic(syms, tabs, 1) == (476.0, 96 + 4 * 7.0)
    assert smoke.k5_traffic(syms, tabs, 0) == (444.0, 96 + 4 * 3.0)
    pad = torch.tensor([-1, 5], dtype=torch.int32)
    assert smoke.k5_traffic(pad, tabs, 13) == (264.0, 64 + 4 * 2.0)


def test_k5_traffic_counts_the_first_32_slots_only(smoke):
    """A phrase of 48 gaps (rule 8 = (7, 7), 7 = (6, 6), 6 = (5, 5), 5 =
    (4, 4) over the grammar above): only the nodes that hold one of its
    first 32 slots count, each once, however many slots pass through it,
    and never the slots past the phrase's length — not one design's loop
    trips.  Rule 7 on the left holds 24 slots (its whole tree, 47
    nodes); the right 7 holds 8: itself, its left 6 (8 slots), that 6's
    left 5 whole (11 nodes) and its right 5 with 2 slots (5, its 4, the
    4's 3 and the 3's two terminals: 5 nodes)."""
    tabs = _k5_tables([-1, -1, -1, 0, 3, 4, 5, 6, 7],
                      [-1, -1, -1, 1, 2, 4, 5, 6, 7],
                      [1, 1, 1, 2, 3, 6, 12, 24, 48])
    syms = torch.tensor([8], dtype=torch.int32)
    nodes = 1 + 47 + (1 + 1 + 11 + 5)
    assert smoke.k5_traffic(syms, tabs, 13) == (4 + 128 + 16 * 9.0,
                                                32 + 4.0 * nodes)


def test_k5_layout_hand_count(smoke):
    """Symbols [4, 0, 3, 4] of the grammar above: 3 + 1 + 2 + 3 gaps of
    128 slots; depths 2, 0, 1, 2."""
    tabs = _k5_tables([-1, -1, -1, 0, 3], [-1, -1, -1, 1, 2],
                      [1, 1, 1, 2, 3])
    syms = torch.tensor([4, 0, 3, 4], dtype=torch.int32)
    assert smoke.k5_layout(syms, tabs) == dict(
        symbols=4, gap_slots=9 / 128, depth_mean=1.25, depth_max=2)
