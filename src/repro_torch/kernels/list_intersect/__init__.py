"""Kernel K1: batched next_geq over the paged Re-Pair stream
(``csrc/list_intersect.cu``), fully resident or through a resident pool's
slot table, its host router and plain version, and the one-shot surface
that packs a flat or paged index on the fly."""

from .ops import (list_intersect, next_geq, next_geq_paged, next_geq_probe,
                  next_geq_resident, paged_intersect, paged_intersect_plain)

__all__ = ["list_intersect", "next_geq", "next_geq_paged", "next_geq_probe",
           "next_geq_resident", "paged_intersect", "paged_intersect_plain"]
