"""In-RAM page store: the fully resident behaviour behind the seam.

A copy of ``repro/store/memory.py`` (numpy) for the port."""

from __future__ import annotations

import numpy as np

from .base import PageStore


class MemoryPageStore(PageStore):
    """Zero-copy wrapper over host-resident paged stream arrays.  The same
    numpy buffers an engine pages its device arrays from ARE the store —
    ``gather`` is a fancy-index, no I/O, no duplication."""

    kind = "memory"

    def __init__(self, syms_pg: np.ndarray, sums_pg: np.ndarray,
                 n_syms: int, meta: dict):
        syms_pg = np.ascontiguousarray(syms_pg, np.int32)
        sums_pg = np.ascontiguousarray(sums_pg, np.int32)
        if syms_pg.shape != sums_pg.shape or syms_pg.ndim != 2:
            raise ValueError("syms/sums page arrays must share a 2-D shape")
        super().__init__(syms_pg, sums_pg, syms_pg.shape[1], n_syms, meta)
