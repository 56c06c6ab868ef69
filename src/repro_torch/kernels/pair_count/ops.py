"""Kernel K4, ``pair_count``: exact counts of candidate pairs over the
adjacent-pair stream of Re-Pair's working sequence.

The CUDA kernel (``csrc/pair_count.cu``) replaces the TPU kernel
``repro/kernels/pair_count/pair_count.py:50 pair_count_pallas``: for K
candidate pairs ``(cand_a[k], cand_b[k])`` and N pair slots
``(pa[i], pb[i], vm[i])``,

    counts[k] = #{ i : vm[i] != 0 and pa[i] == cand_a[k]
                       and pb[i] == cand_b[k] }

and 0 where ``cand_a[k] < 0`` (the sentinel of an unused table slot).  A
candidate that appears twice gets the full count in each of its slots; K
and N are any lengths, and the candidates come in any order.  This module
holds:

* ``pair_stream`` — the (left, right, validity) pair stream of a working
  sequence, the port of ``repro/kernels/pair_count/ops.py:27
  _pair_stream`` (flat: the card needs no tiles);
* ``pair_count_plain`` — the plain version: sort the candidates' 64-bit
  keys, ``searchsorted`` every valid slot's key into them, ``bincount``
  the hits, and read each candidate's count at its key's first position;
* ``count_plan`` and ``pair_slot`` — the kernel's launch geometry (hash
  table per block, chunks, grid) and its hash function, on the host;
* ``pair_count`` — the wrapper: checks its tensors, launches the kernel
  on CUDA tensors, runs the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import check_operands, launch, sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 5

#: candidate keys in one block's hash table; a longer table is cut into
#: chunks of this many, each counted over the whole stream
CHUNK = 4096
#: the fewest pair slots a block of the grid counts
MIN_SLOTS_PER_BLOCK = 4096


class CountPlan(NamedTuple):
    """One launch's geometry: ``chunk`` keys per hash table (the grid's y
    axis has one block row per chunk), tables of ``2**bits`` slots,
    ``blocks`` on the grid's x axis."""
    chunk: int
    bits: int
    blocks: int


def count_plan(K: int, N: int, sms: int) -> CountPlan:
    """Launch geometry of K4 for K candidates over N slots on a card of
    ``sms`` SMs: tables of at least four times their keys (a power of two,
    64 or more), one block per SM — split over the chunks — but none with
    fewer than ``MIN_SLOTS_PER_BLOCK`` slots."""
    chunk = max(1, min(K, CHUNK))
    bits = max(6, (chunk - 1).bit_length() + 2)
    blocks = max(1, min(-(-N // MIN_SLOTS_PER_BLOCK), sms // -(-K // chunk)))
    return CountPlan(chunk, bits, blocks)


def pair_slot(a, b, bits: int) -> np.ndarray:
    """The home slot of each pair's key in a table of ``2**bits`` slots —
    the kernel's ``slot_of``: the key folded to 64 bits by ``x ^ x >> 32``,
    times the 64-bit golden ratio (wrapping), top ``bits`` bits."""
    key = (np.asarray(a, np.int64) << 32) + (np.asarray(b, np.int64)
                                             & 0xFFFFFFFF)
    x = key.astype(np.uint64)
    x ^= x >> np.uint64(32)
    x *= np.uint64(0x9E3779B97F4A7C15)
    return (x >> np.uint64(64 - bits)).astype(np.int64)


def pair_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 key per pair, ``a * 2**32 + (b mod 2**32)``: equal keys
    for equal int32 pairs, ordered by (a signed, b unsigned) — the key
    the kernel sorts and searches."""
    return a.long() * (1 << 32) + (b.long() & 0xFFFFFFFF)


def pair_stream(seq: torch.Tensor, active: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pa, pb, vm) int32 for every adjacent slot ``(seq[i], seq[i+1])``
    of the sequence: slot ``i`` is valid iff both positions are active
    and ``i + 1 < n``."""
    i32 = torch.int32
    Np = seq.shape[0]
    idx = torch.arange(Np, dtype=i32, device=seq.device)
    pb = torch.cat([seq[1:], seq.new_zeros(1)]).to(i32)
    b_act = torch.cat([active[1:], active.new_zeros(1)]).bool()
    vm = (active.bool() & b_act & (idx + 1 < n)).to(i32)
    return seq.to(i32).contiguous(), pb.contiguous(), vm


def pair_count_plain(cand_a: torch.Tensor, cand_b: torch.Tensor,
                     pa: torch.Tensor, pb: torch.Tensor,
                     vm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, O((N + K) log K): no K × N
    compare is materialised."""
    K = cand_a.shape[0]
    if K == 0:
        return torch.zeros(0, dtype=torch.int32, device=cand_a.device)
    keys = pair_keys(cand_a, cand_b)
    sk, _ = torch.sort(keys)
    slot = pair_keys(pa, pb)[vm != 0]
    pos = torch.searchsorted(sk, slot).clamp(max=K - 1)
    hist = torch.bincount(pos[sk[pos] == slot], minlength=K)
    first = torch.searchsorted(sk, keys)          # first equal key
    return torch.where(cand_a < 0, 0, hist[first]).to(torch.int32)


def pair_count(cand_a: torch.Tensor, cand_b: torch.Tensor,
               pa: torch.Tensor, pb: torch.Tensor,
               vm: torch.Tensor) -> torch.Tensor:
    """(K,) int32 exact counts of the candidate pairs over the valid pair
    slots.  CUDA tensors launch the kernel; CPU tensors run
    :func:`pair_count_plain`; anything else raises."""
    dev = cand_a.device
    check_operands("pair_count", dev, cand_a=cand_a, cand_b=cand_b, pa=pa,
                   pb=pb, vm=vm)
    K, N = cand_a.shape[0], pa.shape[0]
    if cand_a.dim() != 1 or cand_b.shape != (K,) or pa.dim() != 1 \
            or pb.shape != (N,) or vm.shape != (N,):
        raise ValueError("pair_count: candidates must share one (K,) shape "
                         "and the pair stream one (N,) shape")
    if dev.type == "cpu":
        return pair_count_plain(cand_a, cand_b, pa, pb, vm)
    if dev.type != "cuda":
        raise ValueError(f"pair_count: unsupported device {dev}")
    out = torch.zeros_like(cand_a)
    if K:
        plan = count_plan(K, N, sm_count(dev))
        launch("pair_count", dev, _ARGTYPES, cand_a.data_ptr(),
               cand_b.data_ptr(), pa.data_ptr(), pb.data_ptr(),
               vm.data_ptr(), out.data_ptr(), K, N, *plan)
    return out
