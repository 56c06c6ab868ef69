"""Bounded LRU cache shared by the engine decode cache and the serving
scheduler's per-index caches (DESIGN.md §8.3).

A thin ``OrderedDict`` wrapper rather than ``functools.lru_cache`` because
the serving caches need (a) explicit invalidation on index hot-swap,
(b) hit/miss counters surfaced through ``QueryServer`` stats, and
(c) keys built at call sites (index version tokens) rather than derived
from function arguments.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Least-recently-used mapping with a hard entry bound.

    ``maxsize <= 0`` disables caching entirely (every ``get`` is a miss,
    ``put`` is a no-op) — the knob CI uses to prove nothing *depends* on a
    cache being present.
    """

    __slots__ = ("maxsize", "hits", "misses", "evictions", "_d")

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._d: OrderedDict[Hashable, Any] = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key not in self._d:
            self.misses += 1
            return default
        self.hits += 1
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: Hashable, value: Any) -> None:
        if self.maxsize <= 0:
            return
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def flush(self) -> None:
        """Drop every entry (index hot-swap); counters survive so stats
        remain cumulative across swaps."""
        self._d.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._d), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0}
