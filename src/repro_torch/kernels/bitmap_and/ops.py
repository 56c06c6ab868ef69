"""Kernel K8, ``bitmap_and``: the AND of two uint32 bitmaps and the
number of bits set in it ([MC07] hybrid bitmaps).

The CUDA kernel (``csrc/bitmap_and.cu``) replaces the TPU kernel
``repro/kernels/bitmap_and/bitmap_and.py:36 bitmap_and_pallas``.  The
Pallas kernel returns one count per tile; the wrappers of
``repro/kernels/bitmap_and/ops.py`` (``bitmap_and`` :26,
``bitmap_and_count`` :38) return the AND and one int32 total, and so do
these.  This module holds:

* ``popcount32`` — the SWAR popcount of 32-bit words, in int64;
* ``bitmap_and_plain`` / ``bitmap_and_count_plain`` — the plain versions.
  They compute on int32 views of the words (the same bits): PyTorch's
  uint32 has only some operators, and its ``>>`` on int32 is arithmetic;
* ``bitmap_and`` / ``bitmap_and_count`` — the wrappers: check their
  tensors, launch the kernel on CUDA tensors, run the plain versions on
  CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_operands, launch

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I]


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word of ``w`` (any 32-bit integer dtype),
    as int64: the SWAR steps of the reference on the words' unsigned
    value widened to int64, where every shift is logical."""
    v = w.view(torch.int32).long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def bitmap_and_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the AND: (N,) uint32."""
    return (a.view(torch.int32) & b.view(torch.int32)).view(torch.uint32)


def bitmap_and_count_plain(a: torch.Tensor, b: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the AND and its popcount: the total is
    summed in int64 and wraps to int32 as the reference's int32 sum
    does."""
    w = bitmap_and_plain(a, b)
    return w, popcount32(w).sum().to(torch.int32)


def _operands(name: str, a: torch.Tensor, b: torch.Tensor) -> int:
    check_operands(name, a.device, torch.uint32, a=a, b=b)
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError(f"{name}: a and b must share one (N,) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")
    return int(a.shape[0])


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (N,) uint32 words -> (N,) uint32 AND.  CUDA tensors launch the
    kernel; CPU tensors run :func:`bitmap_and_plain`; anything else
    raises."""
    n = _operands("bitmap_and", a, b)
    if a.device.type == "cpu":
        return bitmap_and_plain(a, b)
    out = torch.empty_like(a)
    if n:
        launch("bitmap_and", a.device, _ARGTYPES, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), None, n)
    return out


def bitmap_and_count(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (N,) uint32 words -> (the (N,) uint32 AND, its popcount as an
    int32 0-dim tensor).  CUDA tensors launch the kernel; CPU tensors run
    :func:`bitmap_and_count_plain`; anything else raises."""
    n = _operands("bitmap_and_count", a, b)
    if a.device.type == "cpu":
        return bitmap_and_count_plain(a, b)
    out = torch.empty_like(a)
    if not n:
        return out, torch.zeros((), dtype=torch.int32, device=a.device)
    total = torch.empty((), dtype=torch.int32, device=a.device)
    launch("bitmap_and", a.device, _ARGTYPES, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), total.data_ptr(), n)
    return out, total
