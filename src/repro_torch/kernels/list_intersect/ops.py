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
* ``list_intersect`` — the wrapper: checks its tensors, launches the
  kernel on CUDA tensors, runs ``list_intersect_plain`` on CPU tensors;
* ``next_geq_paged`` — numpy in, numpy out: route, launch, unsort.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import check_operands, launch
from ...core.index import PagedIndex
from ...engine.torch_backend import paged_readers, skip_descend

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 4
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


def pad_paged_operands(pi: PagedIndex
                       ) -> tuple[dict[str, torch.Tensor], dict, dict]:
    """Kernel operand pack for one paged index: the device tables (no lane
    padding is needed on the card), static bounds, and the numpy routing
    snapshot.  Compute once per index (``CudaEngine`` caches it)."""
    fl = pi.flat
    tables = dict(starts=fl.starts, lasts=fl.lasts, sym_left=fl.sym_left,
                  sym_right=fl.sym_right, sym_sum=fl.sym_sum,
                  c_syms_pg=pi.c_syms_pg, c_sums_pg=pi.c_sums_pg)
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


def list_intersect_plain(lids, xs, pos0, s0, tables: dict, *, max_scan: int,
                         max_depth: int, T: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the fixed-trip-count program of
    ``repro/engine/jnp_backend.py:98 _next_geq_one_paged`` from the
    router's start state."""
    read_sym, read_sum = paged_readers(tables["c_syms_pg"],
                                       tables["c_sums_pg"])
    return skip_descend(tables, T=T, max_scan=max_scan, max_depth=max_depth,
                        read_sym=read_sym, read_sum=read_sum, list_ids=lids,
                        xs=xs, pos=pos0, s=s0)


def list_intersect(lids: torch.Tensor, xs: torch.Tensor, pos0: torch.Tensor,
                   s0: torch.Tensor, tables: dict, *, max_scan: int,
                   max_depth: int, T: int) -> torch.Tensor:
    """(Q,) routed lanes -> (Q,) int32 next_geq values, INT_INF where no
    element >= x exists.  CUDA tensors launch the kernel; CPU tensors run
    :func:`list_intersect_plain`; anything else raises."""
    dev = lids.device
    check_operands("list_intersect", dev, lids=lids, xs=xs, pos0=pos0, s0=s0,
                   **{k: tables[k] for k in _TABLES})
    q = lids.shape[0]
    if lids.dim() != 1 or any(t.shape != (q,) for t in (xs, pos0, s0)):
        raise ValueError("list_intersect: lane arrays must share one (Q,) "
                         "shape")
    if tables["c_syms_pg"].shape != tables["c_sums_pg"].shape:
        raise ValueError("list_intersect: paged stream tables differ")
    if dev.type == "cpu":
        return list_intersect_plain(lids, xs, pos0, s0, tables,
                                    max_scan=max_scan, max_depth=max_depth,
                                    T=T)
    if dev.type != "cuda":
        raise ValueError(f"list_intersect: unsupported device {dev}")
    out = torch.empty_like(lids)
    if q:
        launch("list_intersect", dev, _ARGTYPES,
               *(t.data_ptr() for t in (lids, xs, pos0, s0)),
               *(tables[k].data_ptr() for k in _TABLES), out.data_ptr(),
               q, max_scan, max_depth, T)
    return out


def next_geq_paged(tables: dict, host: dict, list_ids: np.ndarray,
                   xs: np.ndarray, *, max_scan: int, max_depth: int,
                   T: int) -> np.ndarray:
    """Paged next_geq over a cached operand pack: (Q,) ids × (Q,) probes
    -> (Q,) int32 values, INT_INF where no element >= x exists.  Routes on
    the host, runs K1 on the tables' device, restores request order."""
    q = np.asarray(list_ids).shape[0]
    if q == 0:
        return np.zeros(0, np.int32)
    order, *lanes = route_pages(host, list_ids, xs)
    dev = tables["starts"].device
    out = list_intersect(*(torch.from_numpy(a).to(dev) for a in lanes),
                         tables, max_scan=max_scan, max_depth=max_depth, T=T)
    unsort = np.empty(q, np.int64)
    unsort[order] = np.arange(q)
    return out.cpu().numpy()[unsort]
