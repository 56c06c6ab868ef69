"""Device engines: the shared batching/routing logic plus the torch backend.

``DeviceEngine`` owns everything backend-independent — expansion of the
short side, (short, long) normalization, candidate thinning for k-term
queries, the power-of-two round buckets — and delegates exactly one
primitive to the concrete backend: the batched next_geq probe.  Every
pair, k-term query and whole-list decode runs on the engine's device,
whatever the lists' lengths.  ``TorchEngine`` implements it with the plain
PyTorch fixed-trip-count programs (``engine/torch_backend.py``, flat or
paged addressing); ``CudaEngine`` with the hand-written ``list_intersect``
kernel.  Both are interchangeable anywhere and agree bit-exactly.

Every tensor lives on the engine's ``device``, which defaults to
``"cuda"``; ``device="cpu"`` runs the same programs on the CPU (the
tests do).  Asking for CUDA without a card raises.
"""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np
import torch

from ..core.index import (FlatIndex, PagedIndex, build_flat_index,
                          build_paged_index, DEFAULT_PAGE)
from ..core.repair import RePairResult
from ..kernels import resolve_device
from .base import Engine
from . import torch_backend as J


class DeviceEngine(Engine):
    """Backend-independent device-engine scaffolding.

    ``max_short_len`` is the width of one row of expanded short-side
    probes: a short side that fits is one row, a longer one is expanded
    whole and cut into rows of that width, all probed in the same launch.
    """

    def __init__(self, res: RePairResult, fi: FlatIndex | None = None,
                 max_short_len: int = 256, B: int = 8, device="cuda",
                 codec=None, store=None):
        super().__init__(res, codec=codec, store=store)
        self.device = resolve_device(device)
        self.fi = fi if fi is not None else build_flat_index(
            res, B=B, device=self.device)
        if self.fi.device != self.device:
            raise ValueError(f"flat index lives on {self.fi.device}, "
                             f"engine on {self.device}")
        self.max_short_len = max_short_len
        self._bys_incl = None   # [BY04] prefix table, built on first bys

    def _tensor(self, a) -> torch.Tensor:
        """numpy -> int32 tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # -- the one backend-specific primitive --------------------------------

    @abc.abstractmethod
    def _next_geq_dev(self, list_ids: np.ndarray,
                      xs: np.ndarray) -> np.ndarray:
        """(Q,) ids × (Q,) probes (numpy int32) -> (Q,) int32 numpy."""

    def _probe_dev(self, long_ids, xs) -> np.ndarray:
        """(B,) ids × (B, M) probes -> (B, M) int32 numpy, by flattening
        into one batched probe."""
        B, M = np.shape(xs)
        flat_ids = np.repeat(np.asarray(long_ids, np.int32), M)
        return self._next_geq_dev(
            flat_ids, np.asarray(xs, np.int32).reshape(-1)).reshape(B, M)

    # -- engine API ---------------------------------------------------------

    #: merged probe rounds are padded up to power-of-two buckets of at
    #: least this many lanes
    ROUND_BUCKET_MIN = 16

    def _dispatch_algo(self, lids: np.ndarray, xq: np.ndarray,
                       algo: str) -> np.ndarray:
        """Merged-round padding convention for the device tier: the
        scheduler concatenates the pending rounds of every in-flight
        query, so each round's flat size varies tick to tick.  Pad up to
        the next power of two (min ``ROUND_BUCKET_MIN``) by repeating the
        round's first lane — a real (list, probe) — and slice the answers
        back, so every program sees O(log Q) distinct shapes.  The lane
        ledger counts the pad lanes exactly as the JAX package does."""
        n = lids.size
        bucket = max(self.ROUND_BUCKET_MIN, 1 << (n - 1).bit_length())
        if bucket != n:
            lids = np.pad(lids, (0, bucket - n), mode="edge")
            xq = np.pad(xq, (0, bucket - n), mode="edge")
        if self._in_round:
            self.lane_stats["pad_lanes"] += bucket - n
        return np.asarray(super()._dispatch_algo(lids, xq, algo))[:n]

    def _next_geq_repair(self, list_ids: np.ndarray,
                         xs: np.ndarray) -> np.ndarray:
        return np.asarray(self._next_geq_dev(np.asarray(list_ids, np.int32),
                                             np.asarray(xs, np.int32)))

    def _next_geq_repair_bys(self, list_ids: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """Device binary-search path: bisect the span's phrase-sum prefix
        table, then one grammar descent
        (``torch_backend.next_geq_bys_batch``)."""
        if self._bys_incl is None:
            self._bys_incl = J.build_bys_table(self.fi)
        return J.next_geq_bys_batch(
            self.fi, self._bys_incl, self._tensor(list_ids),
            self._tensor(xs)).cpu().numpy()

    def _expand(self, ids, max_len: int) -> torch.Tensor:
        """Batched list expansion on the device: (B,) ids -> (B, max_len)."""
        return J.expand_batch(self.fi, self._tensor(ids), max_len)

    def _expand_rows(self, i: int) -> torch.Tensor:
        """All of list ``i`` expanded on the device and cut into rows of
        ``max_short_len`` probes: (ceil(n / max_short_len), max_short_len),
        INT_INF past the end."""
        m = self.max_short_len
        rows = max(1, -(-int(self.lengths[i]) // m))
        return self._expand([i], rows * m).reshape(rows, m)

    def _decode_list(self, i: int) -> np.ndarray:
        """Whole-list decode via the device positional-descent expansion.
        ``max_len`` is the length rounded up to a power of two, so the
        program sees O(log max-length) shapes."""
        n = int(self.lengths[i])
        bucket = max(16, 1 << (max(1, n - 1)).bit_length())
        row = self._expand([i], bucket)
        return self.compact(row[0].cpu().numpy())

    def intersect_pairs(self, pairs: Sequence[tuple[int, int]]
                        ) -> list[np.ndarray]:
        if not len(pairs):
            return []
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        plen = self.lengths[arr]
        swap = plen[:, 0] > plen[:, 1]  # strict: ties keep request order
        shorts = np.where(swap, arr[:, 1], arr[:, 0])
        longs = np.where(swap, arr[:, 0], arr[:, 1])
        # one probe row per pair whose short side fits max_short_len, and
        # ceil(n / max_short_len) rows for a longer one; one probe launch
        fits = np.flatnonzero(self.lengths[shorts] <= self.max_short_len)
        blocks, owner = [], []
        if fits.size:
            blocks.append(self._expand(shorts[fits], self.max_short_len))
            owner.append(fits)
        for qi in np.flatnonzero(self.lengths[shorts] > self.max_short_len):
            blocks.append(self._expand_rows(int(shorts[qi])))
            owner.append(np.full(blocks[-1].shape[0], qi))
        mat = torch.cat(blocks)
        owner = np.concatenate(owner)
        vals = self._probe_dev(longs[owner].astype(np.int32),
                               mat.cpu().numpy())
        kept = J.match_mask(self._tensor(vals), mat).cpu().numpy()
        out: list[list[np.ndarray]] = [[] for _ in range(arr.shape[0])]
        for qi, row in zip(owner.tolist(), kept):
            out[qi].append(row)
        return [self.compact(np.concatenate(rows)) for rows in out]

    def intersect_multi(self, idxs: Sequence[int]) -> np.ndarray:
        """Device-side pairwise svs, shortest-first by uncompressed length
        (§3.3): expand the shortest list once, then thin the candidate row
        through every longer list with batched next_geq probes.  The row
        keeps its (1, W) shape throughout: W is ``max_short_len``, or the
        shortest list's length rounded up to a multiple of it."""
        order = self.order_by_length(idxs)
        if not order:
            return np.empty(0, dtype=np.int64)
        cand = self._expand_rows(order[0]).reshape(1, -1)
        for i in order[1:]:
            vals = self._probe_dev(np.asarray([i], np.int32),
                                   cand.cpu().numpy())
            cand = J.match_mask(self._tensor(vals), cand)
        return self.compact(cand[0].cpu().numpy())

    # -- ranked scoring -----------------------------------------------------

    def _score_page_size(self) -> int:
        """Cut the score directory at THIS engine's page boundaries: a
        paged engine scores by the pages its probes read, and the
        ``page_score`` kernel addresses entries by those pages."""
        pi = getattr(self, "pi", None)
        return int(pi.page_size) if pi is not None else DEFAULT_PAGE

    #: ScoreRound rows carry whole decoded pages, so their bucket floor is
    #: lower than the probe lanes' — a serial query's chunk fits in one
    SCORE_BUCKET_MIN = 8

    def _dispatch_score_unique(self, entries: np.ndarray) -> np.ndarray:
        """Merged ScoreRound (post-dedup) with the same power-of-two
        bucket convention as ``dispatch_round``: pad the entry lanes with
        the directory's cheapest entry (fewest elements), slice the rows
        back."""
        e = np.asarray(entries, np.int32).ravel()
        n = e.size
        bucket = max(self.SCORE_BUCKET_MIN, 1 << (n - 1).bit_length())
        if bucket != n:
            pad_id = int(np.argmin(self.score_index.pg_count))
            e = np.pad(e, (0, bucket - n), constant_values=pad_id)
            if self._in_round:
                self.lane_stats["pad_lanes"] += bucket - n
        return self.decode_page_batch(e)[:n]

    def decode_page_batch(self, entries: np.ndarray) -> np.ndarray:
        """Device page-entry decode: gather each entry's (symbol range,
        base, head) row from the directory and run the windowed positional
        descent (``torch_backend.decode_pages_batch``) — O(page) work per
        lane regardless of list length, the block-max pruning payoff."""
        si = self.score_index
        e = np.asarray(entries, np.int64).ravel()
        out = J.decode_pages_batch(
            self.fi, self._tensor(si.pg_sym_lo[e]),
            self._tensor(si.pg_sym_hi[e]), self._tensor(si.pg_base[e]),
            self._tensor(si.pg_head[e]), win=int(si.page_size),
            max_elems=self.page_elem_bucket())
        return out.cpu().numpy()

    def score_batch(self, doc_ids: np.ndarray, terms) -> np.ndarray:
        """Device-side score accumulation: the membership probes ride the
        batched next_geq path, the float32 reduction runs on the device
        (``accumulate_scores_device`` — sequential adds in the same fixed
        term order as the host reference, so the scores are
        bit-identical)."""
        si = self.score_index
        docs = np.asarray(doc_ids, np.int64).ravel()
        ts = np.asarray(sorted({int(t) for t in terms
                                if 0 <= int(t) < self.lengths.size}),
                        np.int64)
        if docs.size == 0 or ts.size == 0:
            return np.zeros(docs.size, np.float32)
        lids = np.repeat(ts, docs.size).astype(np.int32)
        xs = np.tile(docs, ts.size).astype(np.int32)
        member = (np.asarray(self.next_geq_batch(lids, xs), np.int64)
                  .reshape(ts.size, docs.size) == docs)
        out = J.accumulate_scores_device(
            torch.from_numpy(si.idf[ts]).to(self.device),
            torch.from_numpy(si.doc_w[docs]).to(self.device),
            torch.from_numpy(member).to(self.device))
        return out.cpu().numpy()


class TorchEngine(DeviceEngine):
    """Plain PyTorch fixed-trip-count programs (the kernels' bit-exact
    reference).  ``paged=True`` routes probes through the paged-addressing
    mirror over a :class:`PagedIndex` — same values, page-local reads."""

    name = "torch"

    def __init__(self, res: RePairResult, fi: FlatIndex | None = None,
                 max_short_len: int = 256, B: int = 8, paged: bool = False,
                 page_size: int = DEFAULT_PAGE,
                 pi: PagedIndex | None = None, **kwargs):
        super().__init__(res, fi=fi, max_short_len=max_short_len, B=B,
                         **kwargs)
        self.pi = pi if pi is not None else (
            build_paged_index(self.fi, page_size) if paged else None)

    def _next_geq_dev(self, list_ids, xs) -> np.ndarray:
        lids, xq = self._tensor(list_ids), self._tensor(xs)
        if self.pi is not None:
            out = J.next_geq_batch_paged(self.pi, lids, xq)
        else:
            out = J.next_geq_batch(self.fi, lids, xq)
        return out.cpu().numpy()
