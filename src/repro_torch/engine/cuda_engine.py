"""CudaEngine: the hand-written CUDA kernels behind the engine API.

The counterpart of ``repro/engine/pallas_engine.py``.  Every probe of a
Re-Pair list — membership, pairwise and k-term AND, meld, the repair
lanes of every merged scheduler round — runs kernel K1
(``kernels/list_intersect``) over the paged stream: the host router
(bucket lookup, anchor-page sort) is numpy, the kernel does the
phrase-sum skipping and grammar descent.  Under a codec tier every probe
of an Elias-Fano list runs kernel K3 (``kernels/ef_next_geq``), selects
and low-bits search in one launch.  Every ranked ScoreRound decodes its
page entries with kernel K2 (``kernels/page_score``).  Expansion of the
short side, the [BY04] binary search and the bitmap probe reuse the
plain PyTorch programs, as ``PallasEngine`` reuses jnp for them.  The
paged index and the kernels' operand packs are built once per index and
reused for every launch.

On a CUDA device the kernels launch or raise; with ``device="cpu"`` the
wrappers run the kernels' plain versions, which is how the CPU tests hold
this engine to the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.index import FlatIndex, PagedIndex, build_paged_index, \
    DEFAULT_PAGE
from ..core.repair import RePairResult
from ..kernels.ef_next_geq import ops as EFK
from ..kernels.list_intersect import ops as K
from ..kernels.page_score import ops as PS
from .device import DeviceEngine


class CudaEngine(DeviceEngine):
    name = "cuda"

    def __init__(self, res: RePairResult, fi: FlatIndex | None = None,
                 max_short_len: int = 256, B: int = 8,
                 page_size: int = DEFAULT_PAGE,
                 pi: PagedIndex | None = None, **kwargs):
        super().__init__(res, fi=fi, max_short_len=max_short_len, B=B,
                         **kwargs)
        self.pi = pi if pi is not None else build_paged_index(self.fi,
                                                              page_size)
        self._tables, self._statics, self._host = K.pad_paged_operands(
            self.pi)
        self._score_pack = None   # page_score operands, first ranked query

    # -- ranked scoring -----------------------------------------------------

    def page_elem_bucket(self) -> int:
        """Row width of a decoded page entry: a multiple of the kernel's
        128-slot tile (the same widths as ``PallasEngine``)."""
        m = max(1, int(self.score_index.max_page_elems))
        return max(PS.TILE_B, 1 << (m - 1).bit_length())

    def decode_page_batch(self, entries) -> np.ndarray:
        """Page entries decode in one ``page_score`` launch.  The score
        directory is always cut at this engine's page boundaries
        (``_score_page_size``), so every entry lies in one stream page."""
        si = self.score_index
        if self._score_pack is None:
            self._score_pack = PS.pad_score_operands(self.pi)
        tables, statics = self._score_pack
        e = np.asarray(entries, np.int64).ravel()
        pages = si.pg_page[e].astype(np.int64)
        slo = si.pg_sym_lo[e].astype(np.int64) - pages * int(si.page_size)
        return PS.page_decode(
            tables, statics, pages, slo, si.pg_sym_hi[e] - si.pg_sym_lo[e],
            si.pg_base[e], si.pg_head[e], si.pg_count[e],
            b_pad=self.page_elem_bucket())

    def _next_geq_dev(self, list_ids, xs) -> np.ndarray:
        return K.next_geq_paged(self._tables, self._host,
                                np.asarray(list_ids), np.asarray(xs),
                                **self._statics)

    # -- codec tier ---------------------------------------------------------

    def _build_ef_pack(self) -> dict:
        """K3's operand pack on this engine's device, with the select
        samples it is built from."""
        rank = self.tier.ef.select_samples()
        return {"samples": rank,
                "dev": EFK.pad_ef_operands(self.tier.ef, rank, self.device)}

    def _ef_next_geq(self, lids, xq) -> np.ndarray:
        return EFK.next_geq_ef(self._ef_pack()["dev"], lids, xq)
