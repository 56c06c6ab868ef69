"""Kernel K1: batched next_geq over the paged Re-Pair stream
(``csrc/list_intersect.cu``), its host router and plain version."""

from .ops import list_intersect, list_intersect_plain, next_geq_paged

__all__ = ["list_intersect", "list_intersect_plain", "next_geq_paged"]
