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

Under a mesh (``mesh=``) the repair lanes run list-sharded, each shard
through K1 over its own paged operand pack (a shard that owns every list
on the engine's card through the engine's own); ``_probe_dev`` stays
replicated, as in ``PallasEngine``.

Out of core (``store=``), the engine follows ``PallasEngine``: it packs
only the five RAM-tier tables of K1, attaches the store, and every
Re-Pair probe runs K1's resident route — the stream read from the
admission cache's pool through its page -> slot table
(``next_geq_resident``).  As in ``PallasEngine``, K2 has no pool route:
ranked page decodes take the windowed resident decode of the plain
PyTorch program (``torch_backend.decode_pages_resident``) on the
engine's device.  That is the reference's design, not a fallback; K2
itself is unchanged.

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
        # out of core the stream pages stay in the pool and enter each
        # launch through the slot table: pack the RAM tier only
        store = self._wants_store()
        self._tables, self._statics, self._host = K.pad_paged_operands(
            self.pi, include_stream=not store)
        self._bind_mesh(int(self.pi.page_size))
        if store:
            # one routing snapshot routes K1's lanes and faults their pages
            self.pi = self._attach_store(self.pi, route_host=self._host)
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
        (``_score_page_size``), so every entry lies in one stream page.
        Out of core the windowed resident decode runs instead."""
        if self.resident is not None:
            return super().decode_page_batch(entries)
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

    def _next_geq_resident(self, lids, xs) -> np.ndarray:
        """K1's resident route: the router's lanes, the pool's device
        mirror and its slot table."""
        return K.next_geq_resident(self._tables, self._host, self.resident,
                                   np.asarray(lids), np.asarray(xs),
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
