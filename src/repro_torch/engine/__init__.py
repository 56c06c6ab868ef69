"""Backend-pluggable query engine over the Re-Pair compressed index.

One API — ``next_geq_batch`` / ``member_batch`` / ``intersect_pairs`` /
``intersect_multi`` — three interchangeable backends:

* ``host``  — the paper's CPU cursor structures (§3.2–3.3);
* ``torch`` — plain PyTorch fixed-trip-count programs (the reference);
* ``cuda``  — the hand-written ``list_intersect`` and ``page_score``
  CUDA kernels.

    eng = make_engine("cuda", repair_result)            # on the card
    eng = make_engine("cuda", repair_result, device="cpu")  # plain versions
    eng.intersect_pairs([(3, 17), (4, 9)])
    eng.intersect_multi([3, 17, 42])          # k-term AND

The device engines default to ``device="cuda"`` and raise without a card.
This registry is the port's own: ``repro.ENGINES`` stays
``{host, jnp, pallas}``.
"""

from __future__ import annotations

from ..core.repair import RePairResult
from .base import Engine
from .cuda_engine import CudaEngine
from .device import DeviceEngine, TorchEngine
from .host import HostEngine

ENGINES: dict[str, type[Engine]] = {
    "host": HostEngine,
    "torch": TorchEngine,
    "cuda": CudaEngine,
}


def make_engine(name: str, res: RePairResult, **kwargs) -> Engine:
    """Construct an engine by backend name.  kwargs pass through to the
    backend constructor (``fi``, ``max_short_len``, ``B``, ``device``,
    ``paged``, ``method``, ...)."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; choose from {sorted(ENGINES)}"
        ) from None
    return cls(res, **kwargs)


__all__ = ["Engine", "DeviceEngine", "HostEngine", "TorchEngine",
           "CudaEngine", "ENGINES", "make_engine"]
