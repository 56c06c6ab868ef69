"""Kernel K7, ``bucket_intersect``: the intersection of two lists laid out
in aligned domain buckets.

The CUDA kernel (``csrc/bucket_intersect.cu``) replaces the TPU kernel
``repro/kernels/bucket_intersect/bucket_intersect.py:34
bucket_intersect_pallas``: for ``a, b`` of shape (NB, CAP), padded with
``INT_INF``,

    out[r, i] = a[r, i] if a[r, i] != INT_INF and a[r, i] in b[r, :]
                else INT_INF

position for position, on any rows (sorted or not, with duplicates).  The
card needs no padding to the TPU's tiles: the output equals the
reference's ``[:NB, :CAP]``.  This module holds:

* ``bucket_intersect_plain`` — the plain version, the row-wise all-pairs
  compare of the reference, cut into row chunks so that the (rows, CAP,
  CAP) compare stays bounded;
* ``bucket_intersect`` — the wrapper, with the contract of
  ``repro/kernels/bucket_intersect/ops.py:22 bucket_intersect``; the
  kernel hashes each row of b into shared memory and probes it with a,
  one warp a row up to CAP 128, one block a row above (b in chunks of
  4,096 past CAP 4,096), so it takes any int32 (NB, CAP);
* ``bucketize`` / ``unbucketize`` — the host layout, copies of
  ``repro/kernels/bucket_intersect/ops.py:36`` and ``:59`` (numpy).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import check_operands, launch

INT_INF = np.int32(2**31 - 1)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 2
#: compare slots of the plain version's (rows, CAP, CAP) chunk
_PLAIN_CHUNK = 1 << 24


def bucket_intersect_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per row, ``a`` kept where it
    equals some element of ``b`` and is not ``INT_INF``."""
    nb, cap = a.shape
    out = torch.empty_like(a)
    step = max(1, _PLAIN_CHUNK // max(cap * cap, 1))
    for r in range(0, nb, step):
        x, y = a[r:r + step], b[r:r + step]
        hit = (x[:, :, None] == y[:, None, :]).any(2) & (x != int(INT_INF))
        out[r:r + step] = torch.where(hit, x, int(INT_INF))
    return out


def bucket_intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (NB, CAP) int32 INT_INF-padded buckets -> (NB, CAP) int32.
    CUDA tensors launch the kernel; CPU tensors run
    :func:`bucket_intersect_plain`; anything else raises."""
    dev = a.device
    check_operands("bucket_intersect", dev, a=a, b=b)
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"bucket_intersect: a and b must share one "
                         f"(NB, CAP) shape, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return bucket_intersect_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"bucket_intersect: unsupported device {dev}")
    nb, cap = a.shape
    if nb >= 2**31 or cap >= 2**31:
        raise ValueError(f"bucket_intersect: (NB, CAP) = ({nb}, {cap}) "
                         f"exceeds the kernel's int32 sizes")
    out = torch.empty_like(a)
    if nb and cap:
        launch("bucket_intersect", dev, _ARGTYPES, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), nb, cap)
    return out


def bucketize(ids: np.ndarray, universe: int, kbits: int,
              cap: int | None = None) -> np.ndarray:
    """Host-side layout: sorted ids -> (n_buckets, cap) int32, bucket b
    holding ids in [b<<kbits, (b+1)<<kbits), INT_INF-padded.  ``cap``
    defaults to the max bucket occupancy (a power-of-two-of-128 round-up
    keeps lanes aligned)."""
    ids = np.asarray(ids, dtype=np.int64)
    nb = (universe >> kbits) + 1
    bucket = (ids >> kbits).astype(np.int64)
    counts = np.bincount(bucket, minlength=nb)
    maxocc = int(counts.max(initial=1))
    if cap is None:
        cap = max(128, -(-maxocc // 128) * 128)
    elif maxocc > cap:
        raise ValueError(f"bucket occupancy {maxocc} exceeds cap {cap}")
    out = np.full((nb, cap), INT_INF, dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for b in range(nb):
        seg = ids[offs[b]:offs[b + 1]]
        out[b, :seg.size] = seg
    return out


def unbucketize(mat: np.ndarray) -> np.ndarray:
    flat = np.asarray(mat).reshape(-1)
    return np.sort(flat[flat != INT_INF]).astype(np.int64)
