"""Kernel K2, ``page_score``: block-max page-entry decode.

The CUDA kernel (``csrc/page_score.cu``) replaces the TPU kernel
``repro/kernels/page_score/page_score.py:122 page_decode_pallas``: each
entry of the block-max directory names one (list, stream page) slice —
symbol window, running base value, head flag, element count — and the
kernel expands it to absolute doc ids, one row per entry.

* ``pad_score_operands`` packs the device tables once per index: the
  grammar tables, the paged symbol/phrase-sum streams the probe kernel
  keeps, and one more paged table, the per-symbol expansion lengths
  (``sym_len[c]``) gathered on the host;
* ``page_score`` — the wrapper: checks its tensors, launches the kernel
  on CUDA tensors, runs ``page_score_plain`` on CPU tensors;
* ``page_decode`` — numpy in, numpy out, what the engine calls per
  ScoreRound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import check_operands, launch
from ...core.index import INT_INF, PagedIndex
from ...engine.torch_backend import descend_position

#: output rows are padded to a multiple of this many slots (the TPU
#: kernel's tile width, kept so both packages share one row geometry)
TILE_B = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I] * 5
_TABLES = ("sym_left", "sym_right", "sym_sum", "sym_len", "c_syms_pg",
           "c_sums_pg", "clens_pg")


def pad_score_operands(pi: PagedIndex) -> tuple[dict[str, torch.Tensor],
                                                 dict]:
    """Kernel operand pack for one paged index: (tables, statics).
    Compute once per index; ``CudaEngine`` caches it on the first ranked
    query."""
    fl = pi.flat
    c = fl.c.cpu().numpy().astype(np.int64)
    lens = fl.sym_len.cpu().numpy()[c]
    page = pi.page_size
    pad = pi.num_pages * page - c.size
    clens_pg = torch.from_numpy(np.pad(lens, (0, pad)).reshape(-1, page)
                                .astype(np.int32)).to(fl.device)
    tables = dict(sym_left=fl.sym_left, sym_right=fl.sym_right,
                  sym_sum=fl.sym_sum, sym_len=fl.sym_len,
                  c_syms_pg=pi.c_syms_pg, c_sums_pg=pi.c_sums_pg,
                  clens_pg=clens_pg)
    statics = dict(max_depth=fl.max_depth, T=fl.num_terminals)
    return tables, statics


def page_score_plain(pages, slo, nsym, base, head, cnt, tables: dict, *,
                     max_depth: int, T: int, b_pad: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the TPU kernel's arithmetic
    over whole pages: masked lengths/sums of each entry's window, int32
    prefix sums, a searchsorted-left per output slot, the positional
    descent, and the output-tile guard on ``cnt``."""
    page = tables["c_syms_pg"].shape[1]
    p = pages.long()
    pos = torch.arange(page, dtype=torch.int32, device=pages.device)[None, :]
    in_span = (pos >= slo[:, None]) & (pos < (slo + nsym)[:, None])
    syms = torch.where(in_span, tables["c_syms_pg"][p], 0)
    lens = torch.where(in_span, tables["clens_pg"][p], 0)
    sums = torch.where(in_span, tables["c_sums_pg"][p], 0)
    cum_len = torch.cumsum(lens, 1, dtype=torch.int32)
    cum_sum = torch.cumsum(sums, 1, dtype=torch.int32) + base[:, None]
    total = head + cum_len[:, page - 1]

    j = torch.arange(b_pad, dtype=torch.int32, device=pages.device)[None, :]
    want = j - head[:, None] + 1    # 1-based gap-element index; < 1 -> base
    w = torch.clamp(want, min=1).contiguous()
    k = torch.searchsorted(cum_len, w, right=False).to(torch.int32)
    k = torch.clamp(k, max=page - 1)
    km1 = torch.clamp(k - 1, min=0).long()
    base_s = torch.where(k > 0, torch.gather(cum_sum, 1, km1), base[:, None])
    base_t = torch.where(k > 0, torch.gather(cum_len, 1, km1), 0)
    sym0 = torch.gather(syms, 1, k.long())
    sym_f, s_f = descend_position(
        tables["sym_left"], tables["sym_right"], tables["sym_sum"],
        tables["sym_len"], T, max_depth, sym0, base_s, w - base_t)
    vals = s_f + tables["sym_sum"][sym_f.long()]
    out = torch.where(want < 1, base[:, None], vals)
    # tile guard: a 128-slot output tile past the entry's count is padding
    live = (j // TILE_B) * TILE_B < cnt[:, None]
    return torch.where(live & (j < total[:, None]), out, int(INT_INF))


def page_score(pages: torch.Tensor, slo: torch.Tensor, nsym: torch.Tensor,
               base: torch.Tensor, head: torch.Tensor, cnt: torch.Tensor,
               tables: dict, *, max_depth: int, T: int,
               b_pad: int) -> torch.Tensor:
    """Decode a batch of page entries: (Q,) int32 metadata — stream page,
    symbol offset in the page, window length, running base, head flag,
    element count — -> (Q, b_pad) int32 doc ids, INT_INF padded.  CUDA
    tensors launch the kernel; CPU tensors run :func:`page_score_plain`;
    anything else raises."""
    dev = pages.device
    meta = dict(pages=pages, slo=slo, nsym=nsym, base=base, head=head,
                cnt=cnt)
    check_operands("page_score", dev, **meta,
                   **{k: tables[k] for k in _TABLES})
    q = pages.shape[0]
    if pages.dim() != 1 or any(t.shape != (q,) for t in meta.values()):
        raise ValueError("page_score: entry arrays must share one (Q,) "
                         "shape")
    if b_pad <= 0 or b_pad % TILE_B:
        raise ValueError(f"b_pad {b_pad} not a positive multiple of "
                         f"{TILE_B}")
    page_shape = tables["c_syms_pg"].shape
    if any(tables[k].shape != page_shape for k in ("c_sums_pg",
                                                    "clens_pg")):
        raise ValueError("page_score: paged stream tables differ")
    if dev.type == "cpu":
        return page_score_plain(pages, slo, nsym, base, head, cnt, tables,
                                max_depth=max_depth, T=T, b_pad=b_pad)
    if dev.type != "cuda":
        raise ValueError(f"page_score: unsupported device {dev}")
    out = torch.empty((q, b_pad), dtype=torch.int32, device=dev)
    if q:
        launch("page_score", dev, _ARGTYPES,
               *(t.data_ptr() for t in meta.values()),
               *(tables[k].data_ptr() for k in _TABLES), out.data_ptr(),
               q, int(page_shape[1]), b_pad, max_depth, T)
    return out


def page_decode(tables: dict, statics: dict, pages: np.ndarray,
                slo: np.ndarray, nsym: np.ndarray, base: np.ndarray,
                head: np.ndarray, cnt: np.ndarray, *,
                b_pad: int) -> np.ndarray:
    """Decode a batch of page entries given as numpy metadata on the
    tables' device; returns the (Q, b_pad) rows as numpy."""
    dev = tables["c_syms_pg"].device
    meta = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (pages, slo, nsym, base, head, cnt))
    return page_score(*meta, tables, b_pad=b_pad, **statics).cpu().numpy()
