"""Kernel K5, ``grammar_expand``: positional Re-Pair phrase expansion.

The CUDA kernel (``csrc/grammar_expand.cu``) replaces the TPU kernel
``repro/kernels/grammar_expand/grammar_expand.py:70
grammar_expand_pallas``: output slot (w, p) holds the (p+1)-th gap of
symbol ``syms[w]``'s expansion, found by a ``max_depth``-step positional
descent, and 0 past the symbol's expanded length.  A symbol id outside
``[0, S)`` reads as the reference's padded table slot (left = right = -1,
sum 0, len 1).  The card takes any W and S: nothing is padded.  This
module holds:

* ``grammar_expand_plain`` — the plain version, the reference's
  fixed-trip-count descent on every slot at once;
* ``grammar_expand`` — the wrapper, with the contract of
  ``repro/kernels/grammar_expand/ops.py:20 grammar_expand``: checks its
  tensors, launches the kernel on CUDA tensors, runs the plain version on
  CPU tensors.  Phrases longer than ``PHRASE_CAP`` are cut, as there.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_operands, launch

#: gaps materialised per symbol (the reference's PHRASE_CAP)
PHRASE_CAP = 32
#: the reference's symbols per tile, to which it pads W; the card pads
#: nothing, and the tests use it to pick a W that is no multiple of it
TILE_W = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 3


def grammar_expand_plain(syms: torch.Tensor, left: torch.Tensor,
                         right: torch.Tensor, sums: torch.Tensor,
                         lens: torch.Tensor, *, max_depth: int
                         ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (W, PHRASE_CAP) int32.  Each
    table gets one padded slot at index S, where every id outside
    ``[0, S)`` reads."""
    S = left.shape[0]
    tabs = [torch.cat([t, t.new_full((1,), v)])
            for t, v in ((left, -1), (right, -1), (sums, 0), (lens, 1))]
    tl, tr, ts, tn = tabs

    def at(s):
        return torch.where((s >= 0) & (s < S), s, S).long()

    W = syms.shape[0]
    sym = syms.repeat_interleave(PHRASE_CAP)
    want = torch.arange(1, PHRASE_CAP + 1, dtype=torch.int32,
                        device=syms.device).repeat(W)
    valid = want <= tn[at(sym)]
    for _ in range(max_depth):
        i = at(sym)
        l = tl[i]
        rule = l >= 0
        ll = tn[at(l)]
        go_left = want <= ll
        sym = torch.where(rule, torch.where(go_left, l, tr[i]), sym)
        want = torch.where(rule & ~go_left, want - ll, want)
    return torch.where(valid, ts[at(sym)], 0).reshape(W, PHRASE_CAP)


def grammar_expand(syms: torch.Tensor, left: torch.Tensor,
                   right: torch.Tensor, sums: torch.Tensor,
                   lens: torch.Tensor, *, max_depth: int) -> torch.Tensor:
    """syms (W,) int32 symbol ids; tables (S,) int32 (left / right = -1
    for terminals, sums = phrase sum or terminal gap, lens = expanded
    length) -> (W, PHRASE_CAP) int32 gaps, rows zero-padded.  CUDA tensors
    launch the kernel; CPU tensors run :func:`grammar_expand_plain`;
    anything else raises."""
    dev = syms.device
    check_operands("grammar_expand", dev, syms=syms, left=left, right=right,
                   sums=sums, lens=lens)
    S = left.shape[0]
    if syms.dim() != 1 or left.dim() != 1 or any(
            t.shape != (S,) for t in (right, sums, lens)):
        raise ValueError("grammar_expand: syms must be (W,) and the four "
                         "tables share one (S,) shape")
    if max_depth < 0:
        raise ValueError(f"grammar_expand: max_depth {max_depth} < 0")
    if dev.type == "cpu":
        return grammar_expand_plain(syms, left, right, sums, lens,
                                    max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"grammar_expand: unsupported device {dev}")
    W = syms.shape[0]
    out = torch.empty((W, PHRASE_CAP), dtype=torch.int32, device=dev)
    if W:
        launch("grammar_expand", dev, _ARGTYPES, syms.data_ptr(),
               left.data_ptr(), right.data_ptr(), sums.data_ptr(),
               lens.data_ptr(), out.data_ptr(), W, S, int(max_depth))
    return out
