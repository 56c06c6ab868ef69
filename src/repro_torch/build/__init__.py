"""Backend-pluggable Re-Pair index construction of the port.

One API — ``init_state`` / ``count_pairs`` / ``replace_round`` /
``build_grammar`` / ``build_index`` — three interchangeable backends that
produce bit-identical grammars, mirroring the engines' ``{host, torch,
cuda}``:

* ``host``  — the paper's offline numpy loop (``repair_compress``);
* ``torch`` — fixed-shape rounds on tensors on one device;
* ``cuda``  — the same rounds with the ``pair_count`` kernel (K4) as the
  histogram.

    bld = make_builder("cuda", table_cap=4096)   # device="cuda" default
    built = bld.build_index(lists, paged=True)   # res + FlatIndex + paged

The device builders (and ``build_index`` of every builder) run on
``device="cuda"`` unless asked for ``device="cpu"``, and raise without a
card.  This is the construction twin of ``repro_torch.engine``: every
consumer (``index/builder.py``, ``QueryServer.rebuild``, the launcher)
depends on the API, never on a backend.
"""

from __future__ import annotations

from .base import (BuildConfig, Builder, BuiltIndex, DEFAULT_RULE_BUDGET)
from .cuda_builder import CudaBuilder
from .host import HostBuilder
from .torch_builder import TorchBuilder

BUILDERS: dict[str, type[Builder]] = {
    "host": HostBuilder,
    "torch": TorchBuilder,
    "cuda": CudaBuilder,
}


def validate_builders(names) -> None:
    """Raise early (before any expensive sweep) on unknown backends."""
    unknown = set(names) - set(BUILDERS)
    if unknown:
        raise ValueError(f"unknown builder(s) {sorted(unknown)}; "
                         f"choose from {sorted(BUILDERS)}")


def make_builder(name: str, config: BuildConfig | None = None,
                 **overrides) -> Builder:
    """Construct a builder by backend name; kwargs override config
    fields (``pairs_per_round``, ``table_cap``, ``max_rules``, ...) and
    may name the ``device``."""
    try:
        cls = BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown builder {name!r}; choose from {sorted(BUILDERS)}"
        ) from None
    return cls(config, **overrides)


__all__ = ["BuildConfig", "Builder", "BuiltIndex", "BUILDERS",
           "CudaBuilder", "DEFAULT_RULE_BUDGET", "HostBuilder",
           "TorchBuilder", "make_builder", "validate_builders"]
