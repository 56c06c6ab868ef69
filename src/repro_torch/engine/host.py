"""HostEngine: the paper's host cursor structures behind the engine API.

Copied from ``repro/engine/host.py``.  Wraps ``core/intersect.py``'s
``CompressedList`` / ``SampledList`` / ``LookupList`` — the bit-exact CPU
reference tier.  ``method`` picks the
sampling structure exactly as §5 of the paper does: ``skip`` (no sampling),
``svs`` ((a)-sampling + galloping), ``lookup`` ((b)-sampling direct bucket
addressing).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import intersect as I
from ..core.cache import LRUCache
from ..core.index import INT_INF
from ..core.repair import RePairResult
from ..core.sampling import (ASampling, BSampling, build_a_sampling,
                             build_b_sampling)
from .base import DECODE_CACHE_SIZE, Engine


class HostEngine(Engine):
    name = "host"

    def __init__(self, res: RePairResult, method: str = "lookup",
                 search: str = "exp", k: int = 8, B: int = 8,
                 codec=None, store=None):
        super().__init__(res, codec=codec, store=store)
        if method not in ("skip", "svs", "lookup"):
            raise ValueError(f"unknown host method {method!r}")
        self.method = method
        self.search = search
        self.asamp: ASampling | None = (build_a_sampling(res, k)
                                        if method == "svs" else None)
        self.bsamp: BSampling | None = (build_b_sampling(res, B)
                                        if method == "lookup" else None)
        # bounded like the decode cache: merged serving rounds touch the
        # whole Zipf head, and accessors hold O(span) decoded state
        self._accs = LRUCache(DECODE_CACHE_SIZE)
        self._qres = res

    def _acc(self, i: int) -> I.CompressedList:
        if self.method == "svs":
            return I.SampledList(self._qres, i, self.asamp, self.search)
        if self.method == "lookup":
            return I.LookupList(self._qres, i, self.bsamp)
        return I.CompressedList(self._qres, i)

    def _decode_list(self, i: int) -> np.ndarray:
        return self._qres.decode_list(i)

    def _acc_cached(self, i: int) -> I.CompressedList:
        """Accessor reuse across unordered probes: the O(span) setup
        (list_symbols + phrase sums) is paid once per list.  SampledList's
        resumable sample bracket assumes non-decreasing probes, so it is
        reset to the fresh-instance state before each reuse."""
        acc = self._accs.get(i)
        if acc is None:
            acc = self._acc(i)
            self._accs.put(i, acc)
        if self.method == "svs":
            acc._t = 0
        return acc

    # -- point operations ---------------------------------------------------

    def _next_geq_repair(self, list_ids: np.ndarray,
                         xs: np.ndarray) -> np.ndarray:
        out = np.empty(len(list_ids), dtype=np.int32)
        for q, (li, x) in enumerate(zip(np.asarray(list_ids),
                                        np.asarray(xs))):
            acc = self._acc_cached(int(li))
            v = acc.next_geq(int(x), acc.cursor())
            out[q] = INT_INF if v is None else v
        return out

    # -- conjunctive queries ------------------------------------------------

    def _pair(self, a: int, b: int) -> np.ndarray:
        a, b = self.order_by_length([a, b])
        if self.method == "svs":
            return I.intersect_svs(self._qres, a, b, self.asamp,
                                   self.search)
        if self.method == "lookup":
            return I.intersect_lookup(self._qres, a, b, self.bsamp)
        return I.intersect_skip(self._qres, a, b)

    def intersect_pairs(self, pairs: Sequence[tuple[int, int]]
                        ) -> list[np.ndarray]:
        return [self._pair(a, b) for a, b in pairs]

    def intersect_multi(self, idxs: Sequence[int]) -> np.ndarray:
        if not idxs:    # parity with the device engines
            return np.empty(0, dtype=np.int64)
        samp = self.asamp if self.method == "svs" else self.bsamp
        return I.intersect_multi(self._qres, list(idxs), samp, self.search)
