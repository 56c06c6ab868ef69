"""CudaBuilder: the torch round structure with the pair histogram counted
by the ``pair_count`` CUDA kernel (K4).

The port of ``repro/build/pallas_builder.py::PallasBuilder``.  Only the
counting stage differs from :class:`TorchBuilder`:

1. one single-key sort of the packed pair stream still identifies the
   DISTINCT pairs (that is what defines the candidate set), but their
   occurrence counts are not taken from run lengths;
2. the candidates are compacted into a **static table** of ``Kp`` slots —
   the first ``table_cap`` distinct pairs by first occurrence (the host's
   [CN07] early-pairs policy verbatim), or all of them when uncapped —
   with ``-1`` sentinels in the unused slots;
3. the kernel counts every candidate over the pair stream
   (``kernels/pair_count``: on CUDA tensors K4, on CPU tensors its plain
   version — never the plain version on the card);
4. ranking/selection/replacement are shared with TorchBuilder, so the
   grammar is bit-identical to both other backends.

The static table is the one approximation surface: with
``table_cap == 0`` the build is exact only while the number of distinct
pairs fits ``config.pair_table``; the per-round ``n_runs`` scalar guards
this and the builder raises (asking for a cap or a bigger table) instead
of silently diverging from the host grammar.
"""

from __future__ import annotations

import torch

from ..kernels.pair_count import pair_count
from .base import BuildConfig
from .torch_builder import (BIG, I32, TorchBuilder, _arange, _cap_kept,
                            _runs_of_sorted, _sort3)


def _count_ranked_cuda(packed, pa, pb, vp, *, S, cap, min_count, Kp):
    """Drop-in for ``torch_builder._count_ranked``: same return contract,
    ranked tensors of length ``Kp``, occurrence counts from K4.  ``n_good
    <= Kp`` by construction, so the exact-fallback redo never triggers for
    this backend."""
    Np = packed.shape[0]
    dev = packed.device
    ks = torch.sort(packed).values
    rs, _, _ = _runs_of_sorted(ks)
    n_runs = rs.sum(dtype=I32)
    kept = _cap_kept(ks, packed, rs, cap=cap) if cap > 0 else rs

    # candidate table: the kept distinct pairs, gather-compacted into Kp
    # static slots, sorted by packed key (ranking re-sorts anyway)
    csum = torch.cumsum(kept, 0, dtype=I32)
    src = torch.searchsorted(csum, _arange(1, Kp + 1, dev))
    on = _arange(0, Kp, dev) < csum[Np - 1]
    kk = torch.where(on, ks[src.clamp(max=Np - 1)], BIG)
    ca = torch.where(on, kk // S, -1)
    cb = torch.where(on, kk % S, -1)

    counts = pair_count(ca, cb, pa, pb, vp.to(I32))

    good = on & (counts >= min_count)
    neg = torch.where(good, -counts, BIG)
    a = torch.where(good, ca, BIG)
    b = torch.where(good, cb, BIG)
    return (*_sort3(neg, a, b, counts), good.sum(dtype=I32), n_runs)


class CudaBuilder(TorchBuilder):
    name = "cuda"

    def __init__(self, config: BuildConfig | None = None, *, device="cuda",
                 **overrides):
        super().__init__(config, device=device, **overrides)
        cfg = self.config
        k_req = cfg.table_cap if cfg.table_cap > 0 else cfg.pair_table
        self._Kp = max(128, -(-k_req // 128) * 128)

    def _count(self, packed, pa, pb, vp, *, S, K):
        cfg = self.config
        return _count_ranked_cuda(packed, pa, pb, vp, S=S,
                                  cap=cfg.table_cap,
                                  min_count=cfg.min_count, Kp=self._Kp)

    def _rank_k(self) -> int | None:
        return self._Kp

    def _check_round(self, n_runs: int) -> None:
        if self.config.table_cap == 0 and n_runs > self._Kp:
            raise RuntimeError(
                f"cuda builder candidate table ({self._Kp}) is smaller "
                f"than the {n_runs} distinct pairs this round; set "
                f"table_cap (capped counting) or raise pair_table to keep "
                f"host parity")
