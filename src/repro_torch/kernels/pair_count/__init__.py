"""Kernel K4: the pair histogram of Re-Pair construction
(``csrc/pair_count.cu``), its pair-stream helper, plain version and numpy
oracle."""

from .ops import pair_count, pair_count_plain, pair_keys, pair_stream
from .ref import pair_count_ref

__all__ = ["pair_count", "pair_count_plain", "pair_count_ref", "pair_keys",
           "pair_stream"]
