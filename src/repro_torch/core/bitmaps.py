"""Hybrid bitmap representation of long lists ([MC07], paper §5.2.2).

Lists longer than ``universe / threshold_div`` (paper uses num_docs/8) are
stored as plain bitmaps; intersection between two bitmap lists is word-wise
AND; bitmap×compressed intersection tests the short list's elements against
the bitmap.  The remaining (short) lists use the pure technique (Re-Pair or
a gap codec), exactly as the paper does: "For Re-Pair, we extract the lists
that would be represented by bitmaps according to the technique, and then we
proceed to the compression phase."
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Bitmap:
    words: np.ndarray   # uint64
    universe: int
    count: int

    def member(self, x: int) -> bool:
        return bool((int(self.words[x >> 6]) >> (x & 63)) & 1)

    def decode(self) -> np.ndarray:
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return np.nonzero(bits[: self.universe])[0].astype(np.int64)

    def size_bits(self) -> int:
        return int(self.words.size) * 64


def build_bitmap(ids: np.ndarray, universe: int) -> Bitmap:
    nwords = (universe + 63) // 64
    bits = np.zeros(nwords * 64, dtype=np.uint8)
    bits[np.asarray(ids, dtype=np.int64)] = 1
    words = np.packbits(bits, bitorder="little").view(np.uint64)
    return Bitmap(words=words, universe=universe, count=int(len(ids)))


def and_bitmaps(a: Bitmap, b: Bitmap) -> np.ndarray:
    w = a.words & b.words
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return np.nonzero(bits[: a.universe])[0].astype(np.int64)


def filter_by_bitmap(short_ids: np.ndarray, bm: Bitmap) -> np.ndarray:
    idx = np.asarray(short_ids, dtype=np.int64)
    words = bm.words[idx >> 6]
    hit = (words >> (idx & 63).astype(np.uint64)) & np.uint64(1)
    return idx[hit.astype(bool)]


def split_for_hybrid(
    lists: Sequence[np.ndarray], universe: int, threshold_div: int = 8
) -> tuple[list[int], list[int]]:
    """Indices of lists that become bitmaps vs stay compressed.  Paper uses
    num_docs / 8 elements as the threshold."""
    thr = universe / threshold_div
    bitmap_idx = [i for i, pl in enumerate(lists) if len(pl) > thr]
    rest_idx = [i for i, pl in enumerate(lists) if len(pl) <= thr]
    return bitmap_idx, rest_idx
