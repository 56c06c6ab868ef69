"""The [MC07] hybrid bitmap query engine over an :class:`InvertedIndex`.

A copy of ``repro/index/hybrid.py`` (numpy over ``core/bitmaps``,
``core/intersect`` and ``core/codecs``) for the port.

Host-only routing the planner does not model: long lists stored as
bitmaps answer with bitwise AND / bitmap filtering, everything else goes
through the paper's §5 method ladder (merge / skip / svs / lookup) or a
byte-code codec.  This is the engine behind the paper's NEGATIVE result
reproduction (``benchmarks/bench_bitmap_hybrid``): bitmaps help byte
codes more than Re-Pair.

Boolean/phrase queries over a *pure* Re-Pair index should use
:class:`repro_torch.query.QueryExecutor` (cost-based planning over the
backend-pluggable engine seam) — this class exists for the index shapes
the seam does not cover: mixed bitmap/compressed/codec storage.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..core import bitmaps as BM
from ..core import intersect as I
from ..core.codecs import svs_encoded

if TYPE_CHECKING:
    from .builder import InvertedIndex


class HybridQueryEngine:
    def __init__(self, index: "InvertedIndex", method: str = "lookup",
                 search: str = "exp"):
        self.ix = index
        self.method = method
        self.search = search

    # -- single pair --------------------------------------------------------
    def _pair(self, i_short: int, i_long: int) -> np.ndarray:
        ix = self.ix
        hs, hl = i_short in ix.bitmaps, i_long in ix.bitmaps
        if hs and hl:
            return BM.and_bitmaps(ix.bitmaps[i_short], ix.bitmaps[i_long])
        if hl:
            short = self._decode(i_short)
            return BM.filter_by_bitmap(short, ix.bitmaps[i_long])
        if hs:
            short = self._decode(i_long)
            return BM.filter_by_bitmap(short, ix.bitmaps[i_short])
        m = self.method
        if m == "merge":
            return I.intersect_merge(self._decode(i_short), self._decode(i_long))
        if m == "skip":
            return I.intersect_skip(ix.repair, i_short, i_long)
        if m == "svs":
            return I.intersect_svs(ix.repair, i_short, i_long, ix.a_samp,
                                   self.search)
        if m == "lookup":
            return I.intersect_lookup(ix.repair, i_short, i_long, ix.b_samp)
        if m in ix.codecs:
            return svs_encoded(self._decode(i_short), ix.codecs[m], i_long)
        raise ValueError(f"unknown method {m}")

    def _pair_cand(self, cand: np.ndarray, i_long: int) -> np.ndarray:
        """Intersect an explicit candidate array with list i_long."""
        ix = self.ix
        if i_long in ix.bitmaps:
            return BM.filter_by_bitmap(cand, ix.bitmaps[i_long])
        m = self.method
        if m == "merge":
            return I.intersect_merge(cand, self._decode(i_long))
        if m == "skip":
            return I._svs_core(cand, I.CompressedList(ix.repair, i_long))
        if m == "svs":
            return I._svs_core(cand, I.SampledList(ix.repair, i_long,
                                                   ix.a_samp, self.search))
        if m == "lookup":
            return I._svs_core(cand, I.LookupList(ix.repair, i_long, ix.b_samp))
        if m in ix.codecs:
            return svs_encoded(cand, ix.codecs[m], i_long)
        raise ValueError(f"unknown method {m}")

    def _decode(self, i: int) -> np.ndarray:
        ix = self.ix
        if i in ix.bitmaps:
            return ix.bitmaps[i].decode()
        return I.CompressedList(ix.repair, i).decode()

    # -- public API ----------------------------------------------------------
    def conjunctive(self, list_ids: list[int]) -> np.ndarray:
        """AND query: pairwise svs shortest-first by uncompressed length
        (§3.3 / [BLOL06])."""
        if not list_ids:
            return np.empty(0, dtype=np.int64)
        order = sorted(list_ids, key=self.ix.list_length)
        if len(order) == 1:
            return self._decode(order[0])
        cand = self._pair(order[0], order[1])
        for i in order[2:]:
            if cand.size == 0:
                break
            cand = self._pair_cand(cand, i)
        return cand

    def disjunctive(self, list_ids: list[int]) -> np.ndarray:
        if not list_ids:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate([self._decode(i) for i in list_ids]))

    def phrase(self, list_ids: list[int],
               verifier=None) -> np.ndarray:
        """Phrase query skeleton: intersect candidate documents, then apply
        a positional verifier if given (the paper: "intersecting the
        documents where the words appear and then postprocessing")."""
        cand = self.conjunctive(list_ids)
        if verifier is None:
            return cand
        keep = [d for d in cand if verifier(int(d), list_ids)]
        return np.asarray(keep, dtype=np.int64)
