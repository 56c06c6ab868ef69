"""Kernel K3, ``ef_next_geq``: Elias-Fano next_geq on the card.

The CUDA kernel (``csrc/ef_next_geq.cu``) replaces the TPU kernel
``repro/kernels/ef_next_geq/ef_next_geq.py:131 ef_intersect_pallas`` and
its host router ``repro/kernels/ef_next_geq/ops.py:41 route_low_pages``:
one thread per lane computes the masks, the high-bits selects (one full
select, its sample page held in registers, and the other two from the
bit runs around it) and the low-bits bucket search, so there is no
router here.
The kernel reads a sample page as two 16-byte loads where ``hi_words``
is 16-byte aligned, and word by word where it is not.  This module
holds:

* ``pad_ef_operands`` — the operand pack of one EF store, built once per
  index (engines cache it with the select samples);
* ``ef_next_geq_plain`` — the plain version,
  ``core.ef.ef_next_geq_torch``;
* ``ef_next_geq`` — the wrapper: checks its tensors, launches the kernel
  on CUDA tensors, runs the plain version on CPU tensors;
* ``next_geq_ef`` — numpy in, numpy out, the contract of the JAX
  package's ``repro/kernels/ef_next_geq/ops.py:117 next_geq_ef``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import check_operands, launch
from ...core.ef import EF_PACK, EFStore, ef_device_pack, ef_next_geq_torch

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 4


def pad_ef_operands(store: EFStore, rank_pg: np.ndarray,
                    device) -> dict[str, torch.Tensor]:
    """Kernel operand pack of one EF store: the int32 tensors of
    :func:`~repro_torch.core.ef.ef_device_pack` on ``device`` (no lane
    padding or paging is needed on the card).  Refuses a store whose bit
    offsets do not fit the int32 arithmetic the kernel shares with the
    reference."""
    if 32 * (int(store.lo_words.size) + 1) >= 2**31:
        raise ValueError(f"ef_next_geq: {store.lo_words.size} low-bits "
                         f"words exceed int32 bit offsets")
    return ef_device_pack(store, rank_pg, device)


def ef_next_geq_plain(lids: torch.Tensor, xs: torch.Tensor,
                      tables: dict) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the fixed-trip-count program
    ``core.ef.ef_next_geq_torch``."""
    return ef_next_geq_torch(tables, lids, xs)


def ef_next_geq(lids: torch.Tensor, xs: torch.Tensor,
                tables: dict) -> torch.Tensor:
    """(Q,) list ids × (Q,) probes -> (Q,) int32 next_geq values, INT_INF
    where no element >= x exists.  CUDA tensors launch the kernel; CPU
    tensors run :func:`ef_next_geq_plain`; anything else raises."""
    dev = lids.device
    check_operands("ef_next_geq", dev, lids=lids, xs=xs,
                   **{k: tables[k] for k in EF_PACK})
    q = lids.shape[0]
    if lids.dim() != 1 or xs.shape != (q,):
        raise ValueError("ef_next_geq: lane arrays must share one (Q,) "
                         "shape")
    L = tables["n"].shape[0]
    if any(tables[k].shape != (L,) for k in ("lbits", "firsts", "lasts")) \
            or any(tables[k].shape != (L + 1,)
                   for k in ("lo_word", "hi_word")) \
            or any(tables[k].dim() != 1 or tables[k].shape[0] < 1
                   for k in ("lo_words", "hi_words", "rank_pg")):
        raise ValueError("ef_next_geq: store tables have inconsistent "
                         "shapes")
    if dev.type == "cpu":
        return ef_next_geq_plain(lids, xs, tables)
    if dev.type != "cuda":
        raise ValueError(f"ef_next_geq: unsupported device {dev}")
    out = torch.empty_like(lids)
    if q:
        launch("ef_next_geq", dev, _ARGTYPES, lids.data_ptr(), xs.data_ptr(),
               *(tables[k].data_ptr() for k in EF_PACK), out.data_ptr(), q,
               tables["lo_words"].shape[0], tables["hi_words"].shape[0],
               tables["rank_pg"].shape[0])
    return out


def next_geq_ef(tables: dict, list_ids: np.ndarray,
                xs: np.ndarray) -> np.ndarray:
    """EF next_geq over a cached operand pack: (Q,) ids × (Q,) probes ->
    (Q,) int32 values, INT_INF where no element >= x exists.  Checks the
    list ids on the host (the kernel reads the directory unchecked), runs
    K3 on the tables' device."""
    lids = np.array(list_ids, np.int32).ravel()
    xq = np.array(xs, np.int32).ravel()
    if lids.size == 0:
        return np.zeros(0, np.int32)
    L = tables["n"].shape[0]
    if int(lids.min()) < 0 or int(lids.max()) >= L:
        raise IndexError(f"ef_next_geq: list id outside [0, {L})")
    dev = tables["n"].device
    out = ef_next_geq(torch.from_numpy(lids).to(dev),
                      torch.from_numpy(xq).to(dev), tables)
    return out.cpu().numpy()
