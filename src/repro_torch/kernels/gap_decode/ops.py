"""Kernel K6, ``gap_decode``: d-gaps to absolute values, row by row.

The CUDA kernel (``csrc/gap_decode.cu``) replaces the TPU kernel
``repro/kernels/gap_decode/gap_decode.py:39 gap_decode_pallas``:

    out[r, t] = firsts[r] + gaps[r, 0] + ... + gaps[r, t]

in wrapping int32 arithmetic, for any (R, C) — the card needs no padding
to the TPU's tiles.  This module holds:

* ``gap_decode_plain`` — the plain version, an int32 ``cumsum`` plus the
  row's first value;
* ``gap_decode`` — the wrapper, with the contract of
  ``repro/kernels/gap_decode/ops.py:18 gap_decode``: checks its tensors,
  launches the kernel on CUDA tensors, runs the plain version on CPU
  tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_operands, launch

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 2


def gap_decode_plain(gaps: torch.Tensor, firsts: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  ``firsts`` is (R,) or (R, 1);
    the int32 ``dtype`` keeps the sum wrapping as the kernel's does."""
    return torch.cumsum(gaps, 1, dtype=torch.int32) + firsts.reshape(-1, 1)


def gap_decode(gaps: torch.Tensor, firsts: torch.Tensor) -> torch.Tensor:
    """gaps (R, C) int32, firsts (R,) or (R, 1) int32 -> (R, C) int32
    absolute values.  CUDA tensors launch the kernel; CPU tensors run
    :func:`gap_decode_plain`; anything else raises."""
    dev = gaps.device
    check_operands("gap_decode", dev, gaps=gaps, firsts=firsts)
    if gaps.dim() != 2 or firsts.shape not in ((gaps.shape[0],),
                                               (gaps.shape[0], 1)):
        raise ValueError(f"gap_decode: gaps must be (R, C) and firsts (R,) "
                         f"or (R, 1), got {tuple(gaps.shape)} and "
                         f"{tuple(firsts.shape)}")
    if dev.type == "cpu":
        return gap_decode_plain(gaps, firsts)
    if dev.type != "cuda":
        raise ValueError(f"gap_decode: unsupported device {dev}")
    R, C = gaps.shape
    out = torch.empty_like(gaps)
    if R and C:
        launch("gap_decode", dev, _ARGTYPES, gaps.data_ptr(),
               firsts.data_ptr(), out.data_ptr(), R, C)
    return out
