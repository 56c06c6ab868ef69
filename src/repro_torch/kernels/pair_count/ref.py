"""Numpy oracle for the pair_count kernel (a copy of
``repro/kernels/pair_count/ref.py``)."""

from __future__ import annotations

import numpy as np


def pair_count_ref(seq: np.ndarray, active: np.ndarray, n: int,
                   cand_a: np.ndarray, cand_b: np.ndarray) -> np.ndarray:
    """Exact counts of each candidate pair over the live, active prefix.
    Sentinel candidates (-1) count zero."""
    seq = np.asarray(seq)
    active = np.asarray(active, dtype=bool)
    a = seq[: max(n - 1, 0)]
    b = seq[1:n]
    valid = active[: max(n - 1, 0)] & active[1:n]
    out = np.zeros(len(cand_a), dtype=np.int32)
    for k, (ca, cb) in enumerate(zip(cand_a, cand_b)):
        if ca < 0:
            continue
        out[k] = int((valid & (a == ca) & (b == cb)).sum())
    return out
