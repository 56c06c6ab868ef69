"""Device engines: the shared batching/routing logic plus the torch backend.

``DeviceEngine`` owns everything backend-independent — expansion of the
short side, (short, long) normalization, candidate thinning for k-term
queries, the power-of-two round buckets, the codec tier's EF and bitmap
probe programs — and delegates exactly one primitive to the concrete
backend: the batched Re-Pair next_geq probe.  Every pair, k-term query
and whole-list decode runs on the engine's device, whatever the lists'
lengths.  ``TorchEngine`` implements it with the plain PyTorch
fixed-trip-count programs (``engine/torch_backend.py``, flat or paged
addressing); ``CudaEngine`` with the hand-written ``list_intersect``
kernel (and its EF lanes with ``ef_next_geq``).  Both are
interchangeable anywhere and agree bit-exactly.

Every tensor lives on the engine's ``device``, which defaults to
``"cuda"``; ``device="cpu"`` runs the same programs on the CPU (the
tests do).  Asking for CUDA without a card raises.

**Out of core** (DESIGN.md §11): with a ``store``, the paged stream goes
behind a page store and the engine keeps only the RAM tier (grammar,
span directory, buckets) on the device; every stream read — probes,
expansions, page decodes — goes through the bounded resident pool of a
:class:`~repro_torch.store.ResidentSet`, whose working set is faulted in
before each dispatch.  The port's device engines have no host fallback
(every pair runs on the device), so the pool has no second user.

**Sharded dispatch**: construct a device engine with a ``mesh``
(:class:`repro_torch.distributed.Mesh`, the devices of its ``data``
axis) and the Re-Pair probe rounds of ``next_geq_batch`` run
list-sharded — the grammar tables are replicated to every shard's
device, the compressed stream, spans and (b)-sampling are
list-partitioned into contiguous shards balanced by stream length
(``shard_flat_index``), each shard answers the lanes whose list it owns
with its engine's own probe (the torch engine's flat program, the cuda
engine's K1), and a max over the shards assembles the batch (every list
has exactly one owner; non-owners emit -1).  One process drives every
shard, as ``repro``'s ``shard_map`` is one program over every device.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..core.index import (FlatIndex, PagedIndex, as_store_backed,
                          build_flat_index, build_paged_index, DEFAULT_PAGE)
from ..core import ef as EF
from ..core.repair import RePairResult
from ..distributed.sharding import INDEX_REPLICATED_FIELDS, Mesh
from ..index import codec_tier as CT
from ..kernels import resolve_device
from ..kernels.list_intersect import ops as K
from ..obs import span, to_host
from ..store import PageStore, ResidentSet, build_page_store, pages_in_spans
from .base import Engine
from . import torch_backend as J


def _np(a) -> np.ndarray:
    """Host copy of a FlatIndex field (tensor on any device, or array)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_flat_index(fi: FlatIndex, num_shards: int
                     ) -> tuple[dict, np.ndarray, np.ndarray]:
    """List-partition a flat index into ``num_shards`` contiguous shards
    balanced by compressed-stream length.

    Returns ``(stacked, shard_of_list, local_lid)``: ``stacked`` maps field
    name -> (num_shards, ...) int32 array (per-shard spans rebased to the
    shard's local stream, everything padded to the widest shard so the
    stack is rectangular), and the two (L,) routing tables give each
    global list its owning shard and its index within it.  Grammar tables
    are NOT here — they replicate.  A shard may own no list (more shards
    than lists); its rows are the padding."""
    starts = _np(fi.starts).astype(np.int64)
    L = starts.size - 1
    N = int(starts[-1])
    c = _np(fi.c).astype(np.int64)
    boffs = _np(fi.bucket_offsets).astype(np.int64)
    bpos = _np(fi.bck_c_pos).astype(np.int64)
    babs = _np(fi.bck_abs).astype(np.int64)
    per_list = {k: _np(getattr(fi, k)).astype(np.int64)
                for k in ("firsts", "lasts", "lengths", "kbits")}

    # contiguous list boundaries closest to equal stream slices
    targets = (np.arange(num_shards + 1) * N) // max(num_shards, 1)
    lb = np.searchsorted(starts, targets, side="left")
    lb[0], lb[-1] = 0, L
    lb = np.maximum.accumulate(lb)

    shard_of_list = np.repeat(np.arange(num_shards), np.diff(lb))
    local_lid = np.arange(L) - lb[shard_of_list]

    l_max = max(1, int(np.diff(lb).max(initial=0)))
    n_max = max(1, int((starts[lb[1:]] - starts[lb[:-1]]).max(initial=0)))
    nb_max = max(1, int((boffs[lb[1:]] - boffs[lb[:-1]]).max(initial=0)))

    def blank(fill, *shape):
        return np.full((num_shards, *shape), fill, dtype=np.int64)

    out = {"c": blank(0, n_max), "starts": blank(0, l_max + 1),
           "bucket_offsets": blank(0, l_max + 1),
           "bck_c_pos": blank(0, nb_max), "bck_abs": blank(0, nb_max),
           "firsts": blank(0, l_max), "lasts": blank(-1, l_max),
           "lengths": blank(0, l_max), "kbits": blank(1, l_max)}
    for d in range(num_shards):
        a, b = lb[d], lb[d + 1]
        c0, c1 = starts[a], starts[b]
        out["c"][d, : c1 - c0] = c[c0:c1]
        loc = starts[a : b + 1] - c0
        out["starts"][d, : b - a + 1] = loc
        out["starts"][d, b - a + 1 :] = loc[-1]
        o0, o1 = boffs[a], boffs[b]
        ob = boffs[a : b + 1] - o0
        out["bucket_offsets"][d, : b - a + 1] = ob
        out["bucket_offsets"][d, b - a + 1 :] = ob[-1]
        out["bck_c_pos"][d, : o1 - o0] = bpos[o0:o1]
        out["bck_abs"][d, : o1 - o0] = babs[o0:o1]
        for k, v in per_list.items():
            out[k][d, : b - a] = v[a:b]
    stacked = {k: v.astype(np.int32) for k, v in out.items()}
    return stacked, shard_of_list.astype(np.int32), local_lid.astype(np.int32)


_STACKED_FIELDS = ("c", "starts", "bucket_offsets", "bck_c_pos", "bck_abs",
                   "firsts", "lasts", "lengths", "kbits")

#: sharded ``next_geq`` dispatches since the last :func:`reset_dispatches`
#: (one per probe round, however many shards answer it)
DISPATCHES = {"sharded_next_geq": 0}


def reset_dispatches() -> None:
    for k in DISPATCHES:
        DISPATCHES[k] = 0


def _placement(dev: torch.device) -> torch.device:
    """A mesh entry as ``resolve_device`` names it, without asking for a
    card: a bare ``cuda`` is the current card (card 0 where none is)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return dev


def _check_placement(mesh: Mesh, home: torch.device) -> None:
    """An engine serves a mesh of the one ``data`` axis, and only from one
    of the mesh's devices: nothing is moved silently."""
    if mesh.axis_names != ("data",):
        raise ValueError(f"list-sharded serving runs over the one 'data' "
                         f"axis, not a mesh of axes {mesh.axis_names}")
    if home not in [_placement(d) for d in mesh.devices]:
        raise ValueError(f"engine on {home} is not a device of the mesh "
                         f"{[str(d) for d in mesh.devices]}")


def _shard_fields(stacked: dict, d: int) -> dict[str, np.ndarray]:
    """Row ``d`` of ``shard_flat_index``'s stacks, its bucket tables cut
    to the shard's own buckets (at least one entry): the paged layout
    addresses every bucket by its owning list."""
    nb = max(1, int(stacked["bucket_offsets"][d, -1]))
    return {k: np.ascontiguousarray(
                v[d, :nb] if k in ("bck_c_pos", "bck_abs") else v[d])
            for k, v in stacked.items()}


def make_sharded_next_geq(fi: FlatIndex, mesh: Mesh,
                          page_size: int | None = None, whole=None):
    """Bind one flat index to the list-sharded ``next_geq`` over the
    mesh's ``data`` axis; returns ``call(gids, xs)`` -> (Q,) int32 numpy.

    Shard ``d`` lives on ``mesh.devices[d]``: row ``d`` of
    ``shard_flat_index``'s stacks, the replicated grammar tables (one
    copy per distinct device; ``fi``'s own on its device) and the GLOBAL
    index's static bounds.  A call probes every shard over all lanes — a
    lane whose list the shard does not own probes local list 0 at x = 0,
    and its answer becomes -1 — and takes the max over the shards in
    int32.  A past-end answer is INT_INF, never -1, so the owner's answer
    always wins.  This is ``repro``'s ``local_next_geq`` plus ``pmax``.

    A shard probes as its engine does: ``page_size=None`` runs the plain
    flat program ``torch_backend.next_geq_batch`` (the torch engine); a
    page size runs kernel K1 (``next_geq_paged``) over the shard's own
    paged operand pack (the cuda engine), so every Re-Pair probe the cuda
    engine serves on a card goes through K1 (``repro`` runs its jnp flat
    program here for its pallas engine too).  ``whole`` — the engine's
    own probe, numpy in and out — serves a shard that owns every list and
    sits on ``fi``'s device: a one-shard mesh there holds no second copy
    of the index.

    The stacks are cut from ``fi`` as it is, so an engine that goes out of
    core binds before it drops the stream, and its shards then hold the
    whole stream on their devices beside the bounded pool: sharding is
    its own residency."""
    home = fi.device
    _check_placement(mesh, home)
    devices = [resolve_device(d) for d in mesh.devices]  # no card: raise
    stacked, shard_of_list, local_lid = shard_flat_index(fi, mesh.size)
    statics = {k: getattr(fi, k) for k in
               ("num_terminals", "max_depth", "max_scan", "universe")}
    grammar = {dev: {k: getattr(fi, k).to(dev)
                     for k in INDEX_REPLICATED_FIELDS}
               for dev in dict.fromkeys(devices + [torch.device("cpu")]
                                        * (page_size is not None))}
    probes, shards = [], []
    for d, dev in enumerate(devices):
        info = dict(device=dev, lists=int((shard_of_list == d).sum()),
                    stream=int(stacked["starts"][d, -1]), tables={})
        shards.append(info)
        if whole is not None and dev == home \
                and info["lists"] == shard_of_list.size:
            probes.append(whole)
            continue
        fields = {k: torch.from_numpy(v)
                  for k, v in _shard_fields(stacked, d).items()}
        if page_size is None:
            info["tables"] = {k: v.to(dev) for k, v in fields.items()}
            probes.append(_flat_probe(FlatIndex(
                **grammar[dev], **info["tables"], **statics)))
        else:
            tables, st, host = K.pad_paged_operands(build_paged_index(
                FlatIndex(**grammar[torch.device("cpu")], **fields,
                          **statics), page_size))
            info["tables"] = {k: v.to(dev) for k, v in tables.items()
                              if k not in INDEX_REPLICATED_FIELDS}
            probes.append(functools.partial(
                K.next_geq_paged, dict(grammar[dev], **info["tables"]),
                host, **st))

    def call(gids, xs) -> np.ndarray:
        DISPATCHES["sharded_next_geq"] += 1
        g = np.asarray(gids, np.int64)
        x = np.asarray(xs, np.int32)
        sof = shard_of_list[g]
        out = np.full(g.shape, -1, np.int32)
        for d, probe in enumerate(probes):
            mine = sof == d
            vals = probe(np.where(mine, local_lid[g], 0).astype(np.int32),
                         np.where(mine, x, 0).astype(np.int32))
            out = np.maximum(out, np.where(mine, vals, -1).astype(np.int32))
        return out

    call.shards = shards
    call.shard_of_list = shard_of_list
    return call


def _flat_probe(shard: FlatIndex):
    """numpy lanes -> numpy answers of the flat program on ``shard``'s
    device."""
    def probe(lids: np.ndarray, xs: np.ndarray) -> np.ndarray:
        dev = shard.c.device
        return to_host(J.next_geq_batch(
            shard, torch.from_numpy(lids).to(dev),
            torch.from_numpy(xs).to(dev)))
    return probe


class DeviceEngine(Engine):
    """Backend-independent device-engine scaffolding.

    ``max_short_len`` is the width of one row of expanded short-side
    probes: a short side that fits is one row, a longer one is expanded
    whole and cut into rows of that width, all probed in the same launch.
    ``mesh`` switches the Re-Pair lanes of ``next_geq_batch`` to the
    list-sharded dispatch; the engine's ``device`` must be one of the
    mesh's devices.  The backend binds it (``_bind_mesh``) once its own
    probe operands exist.
    """

    def __init__(self, res: RePairResult, fi: FlatIndex | None = None,
                 max_short_len: int = 256, B: int = 8, device="cuda",
                 codec=None, store=None, resident_pages=None,
                 mesh: Mesh | None = None):
        device = resolve_device(device)   # no card: raise before any build
        super().__init__(res, codec=codec, store=store,
                         resident_pages=resident_pages)
        self.device = device
        self.fi = fi if fi is not None else build_flat_index(
            res, B=B, device=self.device)
        if self.fi.device != self.device:
            raise ValueError(f"flat index lives on {self.fi.device}, "
                             f"engine on {self.device}")
        self.max_short_len = max_short_len
        self._bys_incl = None   # [BY04] prefix table, built on first bys
        self._route_host = None  # routing snapshot, set by _attach_store
        self._mesh = mesh
        self._sharded_next_geq = None
        if mesh is not None:
            _check_placement(mesh, self.device)   # before any build

    def _bind_mesh(self, page_size: int | None) -> None:
        """Bind the sharded route over the engine's mesh (none: nothing to
        do), probing each shard with the flat program (``page_size``
        None) or K1 at ``page_size``.  Called by the backend once its own
        probe operands exist and before ``_attach_store`` slims
        ``self.fi``, so the shards are cut from the full stream.  Out of
        core the engine's own probe reads the pool, so no shard shares
        it."""
        if self._mesh is not None:
            self._sharded_next_geq = make_sharded_next_geq(
                self.fi, self._mesh, page_size=page_size,
                whole=None if self._wants_store() else self._next_geq_dev)

    # -- out-of-core store attach (DESIGN.md §11) ---------------------------

    def _wants_store(self) -> bool:
        return self._store_kind is not None

    def _attach_store(self, pi: PagedIndex,
                      route_host: dict | None = None) -> PagedIndex:
        """Put a just-built paged index behind the admission cache: build
        (or adopt) the PageStore from the index's own pages, replace the
        stream tensors with placeholders (``as_store_backed``) and the flat
        stream ``c`` with one element, so the device never holds the whole
        stream, and keep one host routing snapshot (``route_host`` when
        the caller already took it, else a fresh one) — the directories,
        buckets and grammar the paper keeps in RAM.  Returns ``pi``
        unchanged when no store was requested."""
        if not self._wants_store():
            return pi
        if pi.store is not None:
            self.store = pi.store
        elif isinstance(self._store_kind, PageStore):
            self.store = self._store_kind
        else:
            self.store = build_page_store(self.res, kind=self._store_kind,
                                          pi=pi)
        self.resident = ResidentSet(self.store, budget=self._resident_pages)
        if int(self.store.page_size) != int(pi.page_size):
            raise ValueError(
                "page store geometry mismatch: store page_size "
                f"{self.store.page_size} != index {pi.page_size}")
        slim = dataclasses.replace(
            self.fi, c=torch.zeros(1, dtype=torch.int32, device=self.device))
        self.fi = slim
        pi = as_store_backed(dataclasses.replace(pi, flat=slim), self.store)
        self._route_host = (route_host if route_host is not None
                            else K.routing_snapshot(pi))
        return pi

    def _pool(self):
        """The resident pool's device mirror (syms, sums, slot table)."""
        return self.resident.device_tables(self.device)

    def _probe_pages(self, lids: np.ndarray, xq: np.ndarray) -> np.ndarray:
        """Working set of a probe round = exactly the pages the router
        windows (``probe_working_set``), so a prefault batch faults
        nothing a dispatch would not.  Sharded probes read their shards'
        own streams, not the pool: their working set is empty."""
        if self._sharded_next_geq is not None:
            return np.zeros(0, np.int64)   # sharding is its own residency
        return K.probe_working_set(self._route_host, lids, xq)

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

    def _dispatch_codec(self, codec: int, lids: np.ndarray, xq: np.ndarray,
                        algo: str) -> np.ndarray:
        """Merged-round padding convention for the device tier: the
        scheduler concatenates the pending rounds of every in-flight
        query, so each (codec, algo) sub-round's flat size varies tick to
        tick.  Pad up to the next power of two (min ``ROUND_BUCKET_MIN``)
        by repeating the sub-round's first lane — a real (list, probe) of
        THIS codec, so the pad lanes stay inside the codec's own tables —
        and slice the answers back, so every program and kernel sees
        O(log Q) distinct shapes.  The lane ledger counts the pad lanes
        exactly as the JAX package does."""
        n = lids.size
        bucket = max(self.ROUND_BUCKET_MIN, 1 << (n - 1).bit_length())
        if bucket != n:
            lids = np.pad(lids, (0, bucket - n), mode="edge")
            xq = np.pad(xq, (0, bucket - n), mode="edge")
        if self._in_round:
            self.lane_stats["pad_lanes"] += bucket - n
        return np.asarray(super()._dispatch_codec(codec, lids, xq,
                                                  algo))[:n]

    def _next_geq_repair(self, list_ids: np.ndarray,
                         xs: np.ndarray) -> np.ndarray:
        lids = np.asarray(list_ids, np.int32)
        xq = np.asarray(xs, np.int32)
        if self._sharded_next_geq is not None:
            return self._sharded_next_geq(lids, xq)
        if self.resident is not None:
            return np.asarray(self._next_geq_resident(lids, xq))
        return np.asarray(self._next_geq_dev(lids, xq))

    def _next_geq_resident(self, lids: np.ndarray,
                           xq: np.ndarray) -> np.ndarray:
        """Resident-pool probe: fault the round's working set (a no-op
        when the scheduler already prefaulted it), then run the
        slot-indexed paged program against the bounded pool."""
        self.resident.ensure(K.probe_working_set(self._route_host, lids, xq))
        ps, pu, st = self._pool()
        return to_host(J.next_geq_batch_resident(
            self.pi, ps, pu, st, self._tensor(lids), self._tensor(xq)))

    def _next_geq_repair_bys(self, list_ids: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """Device binary-search path: bisect the span's phrase-sum prefix
        table, then one grammar descent
        (``torch_backend.next_geq_bys_batch``).  Out of core it delegates
        to the resident probe path: the prefix table is another O(N)
        whole-stream array, which is what the bounded pool exists to
        avoid, and the next_geq contract is the same."""
        if self.resident is not None:
            return self._next_geq_repair(list_ids, xs)
        if self._bys_incl is None:
            self._bys_incl = J.build_bys_table(self.fi)
        return to_host(J.next_geq_bys_batch(
            self.fi, self._bys_incl, self._tensor(list_ids),
            self._tensor(xs)))

    # -- codec-tier device paths --------------------------------------------

    def _build_ef_pack(self) -> dict:
        rank = self.tier.ef.select_samples()
        return {"samples": rank,
                "dev": EF.ef_device_pack(self.tier.ef, rank, self.device)}

    def _ef_next_geq(self, lids, xq) -> np.ndarray:
        return to_host(EF.ef_next_geq_torch(
            self._ef_pack()["dev"], self._tensor(lids), self._tensor(xq)))

    def _bm_pack(self) -> dict:
        key = (self.index_version, "bm")
        pack = self._ef_sel.get(key)
        if pack is None:
            pack = CT.bitmap_device_pack(self.tier.bm, self.device)
            self._ef_sel.put(key, pack)
        return pack

    def _bitmap_next_geq(self, lids, xq) -> np.ndarray:
        """Bitmap lanes run the plain torch program on every device engine:
        the JAX package has no TPU kernel for this probe either."""
        return to_host(CT.bitmap_next_geq_torch(
            self._bm_pack(), self._tensor(lids), self._tensor(xq)))

    def _probe_tiered(self, long_ids, mat) -> np.ndarray:
        """(B,) ids × (B, M) probes with per-list codec routing: without a
        tier the backend's ``_probe_dev`` runs; with one the lanes flatten
        through ``next_geq_batch`` so EF and bitmap lists probe their own
        stores (the values are identical either way).  Out of core the
        lanes flatten too, so they take the resident probe path.  Under a
        mesh ``_probe_dev`` stays replicated on the engine's own tables,
        as in ``repro``; only flattened lanes take the sharded route."""
        if self.tier is None and self.resident is None:
            return self._probe_dev(long_ids, mat)
        B, M = np.shape(mat)
        flat_ids = np.repeat(np.asarray(long_ids, np.int32), M)
        vals = self.next_geq_batch(flat_ids,
                                   np.asarray(mat, np.int32).reshape(-1))
        return np.asarray(vals).reshape(B, M)

    def _expand(self, ids, max_len: int) -> torch.Tensor:
        """Batched list expansion on the device: (B,) ids -> (B, max_len).
        Out of core it reads the resident pool: ``max_len`` bounds the
        symbol window read per list, so only the pages covering
        ``[starts[i], starts[i] + max_len)`` (clipped to the span) are
        faulted."""
        if self.resident is None:
            return J.expand_batch(self.fi, self._tensor(ids), max_len)
        idx = np.asarray(ids, np.int64).ravel()
        starts = self._route_host["starts"]
        lo = starts[idx]
        hi = np.minimum(starts[idx + 1], lo + max_len)
        self.resident.ensure(pages_in_spans(lo, hi, self.pi.page_size))
        ps, pu, st = self._pool()
        return J.expand_batch_resident(self.pi, ps, pu, st,
                                       self._tensor(idx), max_len)

    def _expand_rows(self, i: int) -> torch.Tensor:
        """All of list ``i`` expanded on the device and cut into rows of
        ``max_short_len`` probes: (ceil(n / max_short_len), max_short_len),
        INT_INF past the end."""
        m = self.max_short_len
        rows = max(1, -(-int(self.lengths[i]) // m))
        return self._expand([i], rows * m).reshape(rows, m)

    def _bucket(self, i: int) -> int:
        """Expansion width of list ``i``: its length rounded up to a power
        of two, so the program sees O(log max-length) shapes."""
        n = int(self.lengths[i])
        return max(16, 1 << (max(1, n - 1)).bit_length())

    #: slots one batched expansion of :meth:`_decode_lists` holds at once
    DECODE_BATCH_SLOTS = 1 << 22

    def _decode_lists(self, ids: list[int]) -> list[np.ndarray]:
        """Whole-list decode via the device positional-descent expansion,
        the lists of one width expanded together (a segment's whole
        vocabulary costs a few programs, not one per list).  Each row is
        the program's per-list output, so batching changes no array.  Out
        of core each list is expanded alone, so the pool holds one list's
        pages at a time."""
        widths: dict[int, list[int]] = {}
        for i in ids:
            widths.setdefault(self._bucket(i), []).append(i)
        got: dict[int, np.ndarray] = {}
        for width, group in sorted(widths.items()):
            step = (1 if self.resident is not None
                    else max(1, self.DECODE_BATCH_SLOTS // width))
            for k in range(0, len(group), step):
                chunk = group[k:k + step]
                with span("engine.expand"):
                    rows = to_host(self._expand(chunk, width))
                for i, row in zip(chunk, rows):
                    got[i] = self.compact(row)
        return [got[i] for i in ids]

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
        vals = self._probe_tiered(longs[owner].astype(np.int32),
                                  to_host(mat))
        kept = to_host(J.match_mask(self._tensor(vals), mat))
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
            vals = self._probe_tiered(np.asarray([i], np.int32),
                                      to_host(cand))
            cand = J.match_mask(self._tensor(vals), cand)
        return self.compact(to_host(cand[0]))

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
        lane regardless of list length, the block-max pruning payoff.  Out
        of core the entries' pages are faulted and the same decode reads
        the resident pool (``decode_pages_resident``)."""
        si = self.score_index
        e = np.asarray(entries, np.int64).ravel()
        args = (self._tensor(si.pg_sym_lo[e]), self._tensor(si.pg_sym_hi[e]),
                self._tensor(si.pg_base[e]), self._tensor(si.pg_head[e]))
        kw = dict(win=int(si.page_size), max_elems=self.page_elem_bucket())
        if self.resident is None:
            out = J.decode_pages_batch(self.fi, *args, **kw)
        else:
            self.resident.ensure(pages_in_spans(
                si.pg_sym_lo[e], si.pg_sym_hi[e], self.pi.page_size))
            out = J.decode_pages_resident(self.pi, *self._pool(), *args, **kw)
        return to_host(out)

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
        return to_host(out)


class TorchEngine(DeviceEngine):
    """Plain PyTorch fixed-trip-count programs (the kernels' bit-exact
    reference).  ``paged=True`` routes probes through the paged-addressing
    mirror over a :class:`PagedIndex` — same values, page-local reads.  A
    store implies paged addressing: the admission cache's unit is the
    stream page, so the flat layout has no out-of-core form."""

    name = "torch"

    def __init__(self, res: RePairResult, fi: FlatIndex | None = None,
                 max_short_len: int = 256, B: int = 8, paged: bool = False,
                 page_size: int = DEFAULT_PAGE,
                 pi: PagedIndex | None = None, **kwargs):
        super().__init__(res, fi=fi, max_short_len=max_short_len, B=B,
                         **kwargs)
        self.pi = pi if pi is not None else (
            build_paged_index(self.fi, page_size)
            if (paged or self._wants_store()) else None)
        self._bind_mesh(None)
        if self.pi is not None:
            self.pi = self._attach_store(self.pi)

    def _next_geq_dev(self, list_ids, xs) -> np.ndarray:
        lids, xq = self._tensor(list_ids), self._tensor(xs)
        if self.pi is not None:
            out = J.next_geq_batch_paged(self.pi, lids, xq)
        else:
            out = J.next_geq_batch(self.fi, lids, xq)
        return to_host(out)
