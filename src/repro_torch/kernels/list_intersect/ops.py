"""Kernel K1, ``list_intersect``: batched next_geq over the paged stream.

The CUDA kernel (``csrc/list_intersect.cu``) replaces the TPU kernel
``repro/kernels/list_intersect/list_intersect.py:158
paged_intersect_pallas``.  This module holds, in the order a probe batch
meets them:

* the **host router**, copied from ``repro/kernels/list_intersect/ops.py``
  (``routing_snapshot``, ``pad_paged_operands``, ``_probe_windows``,
  ``route_pages``): the (b)-sampling bucket lookup in numpy, each lane's
  start state ``(pos0, s0)``, and the sort of the lanes by anchor page.
  On the card the sort only buys locality — neighbouring threads read
  neighbouring pages — so the TPU's per-tile base pages, page counts and
  128-lane padding are gone;
* ``paged_intersect`` — the wrapper (the counterpart of
  ``paged_intersect_pallas``): checks its tensors, launches the kernel on
  CUDA tensors, runs ``paged_intersect_plain`` on CPU tensors;
* ``next_geq_paged`` — numpy in, numpy out: route, launch, unsort;
* ``next_geq_resident`` — the out-of-core route of the same kernel
  (``repro/kernels/list_intersect/ops.py:244``): the stream tables are the
  bounded pool of a :class:`~repro_torch.store.ResidentSet`, and every
  stream read goes through its page -> slot table.  The router and the
  lanes are the same; ``probe_working_set`` (copied) is what the pool
  faults in before the launch;
* ``next_geq``, ``next_geq_probe`` and ``list_intersect`` — the one-shot
  surface of ``repro/kernels/list_intersect/ops.py:262``, ``:272`` and
  ``:284``: a flat or paged index in, its operands packed on the fly on
  an explicit ``device`` (``"cuda"`` by default; ``"cpu"`` runs the plain
  version), numpy out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import check_operands, launch, resolve_device
from ...core.index import (INT_INF, FlatIndex, PagedIndex, build_paged_index,
                           flat_index_from_arrays, index_to_arrays,
                           paged_index_from_arrays)
from ...engine.torch_backend import (paged_readers, resident_readers,
                                     skip_descend)
from ...obs import to_host

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 13 + [_I] * 6
_TABLES = ("starts", "lasts", "sym_left", "sym_right", "sym_sum",
           "c_syms_pg", "c_sums_pg")


def routing_snapshot(pi: PagedIndex) -> dict:
    """Numpy snapshot of the routing tables — everything the host page
    router needs (the RAM-tier directories of the paper's split)."""
    fl = pi.flat
    return dict(
        starts=fl.starts.cpu().numpy().astype(np.int64),
        firsts=fl.firsts.cpu().numpy().astype(np.int64),
        lasts=fl.lasts.cpu().numpy().astype(np.int64),
        kbits=fl.kbits.cpu().numpy().astype(np.int64),
        boffs=fl.bucket_offsets.cpu().numpy().astype(np.int64),
        babs=fl.bck_abs.cpu().numpy().astype(np.int64),
        banchor=(pi.bck_page.cpu().numpy().astype(np.int64) * pi.page_size
                 + pi.bck_off.cpu().numpy().astype(np.int64)),
        page_dir=pi.page_dir.cpu().numpy().astype(np.int64),
        page=pi.page_size,
        num_pages=pi.num_pages,
        max_scan=fl.max_scan,
    )


def pad_paged_operands(pi: PagedIndex, include_stream: bool = True
                       ) -> tuple[dict[str, torch.Tensor], dict, dict]:
    """Kernel operand pack for one paged index: the device tables (no lane
    padding is needed on the card), static bounds, and the numpy routing
    snapshot.  Compute once per index (``CudaEngine`` caches it).
    ``include_stream=False`` packs only the five RAM-tier tables — the
    out-of-core route takes the stream from the resident pool per
    launch."""
    fl = pi.flat
    tables = dict(starts=fl.starts, lasts=fl.lasts, sym_left=fl.sym_left,
                  sym_right=fl.sym_right, sym_sum=fl.sym_sum)
    if include_stream:
        tables.update(c_syms_pg=pi.c_syms_pg, c_sums_pg=pi.c_sums_pg)
    statics = dict(max_scan=fl.max_scan, max_depth=fl.max_depth,
                   T=fl.num_terminals)
    return tables, statics, routing_snapshot(pi)


def _probe_windows(host: dict, lids: np.ndarray, xq: np.ndarray):
    """Shared host half of the bucket lookup: start state + per-lane page
    windows.  Returns ``(needs, act_lo, act_hi, pos0, s0)`` — ``needs``
    lanes will read pages ``[act_lo, act_hi]``; settled lanes read nothing
    (bit-identical arithmetic to the device paths)."""
    page = host["page"]
    num_pages = host["num_pages"]
    max_scan = host["max_scan"]

    start = host["starts"][lids]
    end = host["starts"][lids + 1]
    first = host["firsts"][lids]
    last = host["lasts"][lids]
    boff = host["boffs"][lids]
    bnum = host["boffs"][lids + 1] - boff
    b = np.minimum(xq >> host["kbits"][lids], bnum - 1)
    idx = boff + b
    # mirror the TPU kernel's masked gather: out-of-range index reads 0
    nb = host["banchor"].size
    ok = (idx >= 0) & (idx < nb)
    safe = np.clip(idx, 0, max(nb - 1, 0))
    pos0 = np.where(ok, host["banchor"][safe] if nb else 0, 0)
    s0 = np.where(ok, host["babs"][safe] if nb else 0, 0)
    head = xq <= first
    pos0 = np.where(head, start, pos0)
    s0 = np.where(head, first, s0)

    # A lane's window is capped both by the skip budget and by the list's
    # final page from the page directory.
    needs = (s0 < xq) & (pos0 < end) & (xq <= last)
    act_lo = np.clip(pos0 // page, 0, num_pages - 1)
    end_page = np.clip(host["page_dir"][lids + 1], 0, num_pages - 1)
    act_hi = np.minimum((pos0 + max_scan) // page, end_page)
    return needs, act_lo, act_hi, pos0, s0


def probe_working_set(host: dict, list_ids, xs) -> np.ndarray:
    """Unique stream pages the probe batch can touch — exactly the union
    of the active lanes' ``[act_lo, act_hi]`` windows (settled lanes never
    read).  This is what the resident pool faults in before a launch and
    what the scheduler prefaults between ticks."""
    lids = np.asarray(list_ids, np.int64)
    xq = np.asarray(xs, np.int64)
    if lids.size == 0:
        return np.zeros(0, np.int64)
    needs, lo, hi, _, _ = _probe_windows(host, lids, xq)
    if not needs.any():
        return np.zeros(0, np.int64)
    lo, hi = lo[needs], hi[needs]
    width = int((hi - lo).max()) + 1
    grid = lo[:, None] + np.arange(width, dtype=np.int64)
    return np.unique(grid[grid <= hi[:, None]])


def route_pages(host: dict, list_ids: np.ndarray, xs: np.ndarray):
    """Host half of the paged query path: bucket lookup + anchor-page
    sort.  Returns ``(order, lids, xs, pos0, s0)``, the lane arrays int32
    and sorted by anchor page; ``out_sorted[np.argsort(order)]`` restores
    request order.  Lanes that settle without reading a page park at the
    lowest active anchor page, as in the TPU router."""
    lids = np.asarray(list_ids, np.int64)
    xq = np.asarray(xs, np.int64)
    needs, act_lo, _, pos0, s0 = _probe_windows(host, lids, xq)
    park = int(act_lo[needs].min()) if needs.any() else 0
    order = np.argsort(np.where(needs, act_lo, park), kind="stable")
    return (order, lids[order].astype(np.int32), xq[order].astype(np.int32),
            pos0[order].astype(np.int32), s0[order].astype(np.int32))


def poison_outside(syms: torch.Tensor, sums: torch.Tensor,
                   slot_of_page: torch.Tensor, pages, seed: int = 0) -> int:
    """Overwrite in place, with random int32 values (negative and
    ``INT_MIN`` among them), every row of a resident pool mirror that
    holds none of ``pages`` — how the checks of the resident route show
    that its answers over the working set ``pages`` do not depend on any
    other row.  Returns the number of rows poisoned."""
    dev = syms.device
    keep = torch.zeros(syms.shape[0], dtype=torch.bool, device=dev)
    pages = torch.as_tensor(np.asarray(pages, np.int64), device=dev)
    if pages.numel():
        slots = slot_of_page[pages].long()
        keep[slots[slots >= 0]] = True
    bad = (~keep).nonzero().squeeze(1)
    gen = torch.Generator().manual_seed(seed)
    for t in (syms, sums):
        noise = torch.randint(-2**31, 2**31, (bad.numel(), t.shape[1]),
                              generator=gen, dtype=torch.int64)
        noise[:, 0] = -2**31
        t[bad] = noise.to(torch.int32).to(dev)
    return int(bad.numel())


def paged_intersect_plain(lids, xs, pos0, s0, tables: dict, *,
                          max_scan: int, max_depth: int, T: int,
                          slot_of_page=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the fixed-trip-count program of
    ``repro/engine/jnp_backend.py:98 _next_geq_one_paged`` from the
    router's start state — or, given ``slot_of_page``, of its resident
    twin ``next_geq_batch_resident`` (``jnp_backend.py:269``), reading
    the pool ``c_syms_pg`` / ``c_sums_pg`` through the slot table."""
    syms, sums = tables["c_syms_pg"], tables["c_sums_pg"]
    read_sym, read_sum = (
        paged_readers(syms, sums) if slot_of_page is None else
        resident_readers(syms, sums, slot_of_page, int(syms.shape[1])))
    return skip_descend(tables, T=T, max_scan=max_scan, max_depth=max_depth,
                        read_sym=read_sym, read_sum=read_sum, list_ids=lids,
                        xs=xs, pos=pos0, s=s0)


def paged_intersect(lids: torch.Tensor, xs: torch.Tensor, pos0: torch.Tensor,
                    s0: torch.Tensor, tables: dict, *, max_scan: int,
                    max_depth: int, T: int,
                    slot_of_page: torch.Tensor | None = None) -> torch.Tensor:
    """(Q,) routed lanes -> (Q,) int32 next_geq values, INT_INF where no
    element >= x exists.  ``slot_of_page`` (``(num_pages,)`` int32, -1 =
    absent) selects the resident route: ``c_syms_pg`` / ``c_sums_pg`` are
    then the pool's ``(budget, page)`` rows, and every stream read goes
    through the table.  CUDA tensors launch the kernel; CPU tensors run
    :func:`paged_intersect_plain`; anything else raises."""
    dev = lids.device
    check_operands("paged_intersect", dev, lids=lids, xs=xs, pos0=pos0,
                   s0=s0, **{k: tables[k] for k in _TABLES},
                   **({} if slot_of_page is None
                      else {"slot_of_page": slot_of_page}))
    q = lids.shape[0]
    if lids.dim() != 1 or any(t.shape != (q,) for t in (xs, pos0, s0)):
        raise ValueError("paged_intersect: lane arrays must share one (Q,) "
                         "shape")
    if tables["c_syms_pg"].shape != tables["c_sums_pg"].shape:
        raise ValueError("paged_intersect: paged stream tables differ")
    if slot_of_page is not None and slot_of_page.dim() != 1:
        raise ValueError("paged_intersect: slot_of_page must be "
                         "(num_pages,)")
    if dev.type == "cpu":
        return paged_intersect_plain(lids, xs, pos0, s0, tables,
                                     max_scan=max_scan, max_depth=max_depth,
                                     T=T, slot_of_page=slot_of_page)
    if dev.type != "cuda":
        raise ValueError(f"paged_intersect: unsupported device {dev}")
    out = torch.empty_like(lids)
    if q:
        page = int(tables["c_syms_pg"].shape[1])
        slots = (None if slot_of_page is None else slot_of_page.data_ptr())
        n_pages = 0 if slot_of_page is None else int(slot_of_page.shape[0])
        launch("list_intersect", dev, _ARGTYPES,
               *(t.data_ptr() for t in (lids, xs, pos0, s0)),
               *(tables[k].data_ptr() for k in _TABLES), slots,
               out.data_ptr(), q, max_scan, max_depth, T, page, n_pages)
    return out


def next_geq_paged(tables: dict, host: dict, list_ids: np.ndarray,
                   xs: np.ndarray, *, max_scan: int, max_depth: int, T: int,
                   slot_of_page: torch.Tensor | None = None) -> np.ndarray:
    """Paged next_geq over a cached operand pack: (Q,) ids × (Q,) probes
    -> (Q,) int32 values, INT_INF where no element >= x exists.  Routes on
    the host, runs K1 on the tables' device (through ``slot_of_page`` when
    given), restores request order."""
    q = np.asarray(list_ids).shape[0]
    if q == 0:
        return np.zeros(0, np.int32)
    order, *lanes = route_pages(host, list_ids, xs)
    dev = tables["starts"].device
    out = paged_intersect(*(torch.from_numpy(a).to(dev) for a in lanes),
                          tables, max_scan=max_scan, max_depth=max_depth,
                          T=T, slot_of_page=slot_of_page)
    unsort = np.empty(q, np.int64)
    unsort[order] = np.arange(q)
    return to_host(out)[unsort]


def next_geq_resident(tables: dict, host: dict, resident,
                      list_ids: np.ndarray, xs: np.ndarray, *,
                      max_scan: int, max_depth: int, T: int) -> np.ndarray:
    """Out-of-core :func:`next_geq_paged`: ``tables`` is the five-table
    pack (``include_stream=False``).  Faults the batch's working set into
    ``resident`` (a no-op when the scheduler prefaulted it), takes the
    pool's device mirror on the tables' device, and launches K1's
    resident route through the pool's slot table."""
    resident.ensure(probe_working_set(host, list_ids, xs))
    syms, sums, slots = resident.device_tables(tables["starts"].device)
    return next_geq_paged(dict(tables, c_syms_pg=syms, c_sums_pg=sums), host,
                          list_ids, xs, max_scan=max_scan,
                          max_depth=max_depth, T=T, slot_of_page=slots)


def _as_paged(index: FlatIndex | PagedIndex, device) -> PagedIndex:
    """``index`` as a paged index on ``device``: packed anew when it lies
    elsewhere, paged at the default page when it is flat.  A paged index
    whose stream lives behind a page store is refused: its stream tensors
    are placeholders (serve it through an engine's ``store=`` or
    :func:`next_geq_resident`)."""
    dev = resolve_device(device)
    if isinstance(index, PagedIndex):
        if index.store is not None and index.store.kind != "memory":
            raise ValueError("next_geq: the index's stream lives in a page "
                             "store; probe it through next_geq_resident")
        if index.c_syms_pg.device != dev:
            index = paged_index_from_arrays(*index_to_arrays(index), dev)
        return index
    if index.device != dev:
        index = flat_index_from_arrays(*index_to_arrays(index), dev)
    return build_paged_index(index)


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def next_geq(index: FlatIndex | PagedIndex, list_ids, xs,
             device="cuda") -> np.ndarray:
    """One-shot ``next_geq``: (Q,) list ids × (Q,) probes -> (Q,) int32
    values, INT_INF where no element >= x exists.  Packs the paged
    operands of ``index`` on ``device`` on the fly and runs K1 there
    (``"cpu"``: its plain version).  Engines cache the pack instead."""
    tables, statics, host = pad_paged_operands(_as_paged(index, device))
    return next_geq_paged(tables, host, _numpy(list_ids).reshape(-1),
                          _numpy(xs).reshape(-1), **statics)


def next_geq_probe(index: FlatIndex | PagedIndex, list_ids, xs,
                   device="cuda") -> np.ndarray:
    """Row-wise probe: (B,) list ids × (B, M) probes -> (B, M) next_geq
    values, in one launch over the flattened rows."""
    xs = _numpy(xs)
    B, M = xs.shape
    flat_ids = np.repeat(_numpy(list_ids).astype(np.int32), M)
    return next_geq(index, flat_ids, xs.reshape(-1),
                    device=device).reshape(B, M)


def list_intersect(index: FlatIndex | PagedIndex, long_ids, xs,
                   device="cuda") -> np.ndarray:
    """Membership filter of a probe matrix against the long lists: keeps
    ``xs[b, m]`` where it occurs in list ``long_ids[b]``, INT_INF
    elsewhere (INT_INF padding in ``xs`` never matches)."""
    xs = _numpy(xs).astype(np.int32)
    vals = next_geq_probe(index, long_ids, xs, device=device)
    sent = np.int32(INT_INF)
    return np.where((vals == xs) & (xs != sent), xs, sent)
