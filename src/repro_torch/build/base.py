"""The backend-pluggable index-construction API of the port.

A copy of ``repro/build/base.py`` with its index imports pointed at
``core/index.py``.  Construction mirrors the query engine's seam: one
interface, three interchangeable backends, and every consumer
(``index/builder.py``, ``QueryServer.rebuild``, the launcher) depends on
the API, never on a backend:

* :class:`~repro_torch.build.host.HostBuilder`   — the paper's offline
  numpy loop (wraps ``core.repair.repair_compress``);
* :class:`~repro_torch.build.TorchBuilder`       — fixed-shape Re-Pair
  rounds on tensors on one device (adjacent-pair sort histogram + disjoint
  greedy top-k + parity-scan replacement + sort compaction);
* :class:`~repro_torch.build.CudaBuilder`        — the same rounds with
  the pair histogram counted by the ``pair_count`` CUDA kernel (K4).

All three produce **bit-identical grammars** under the same
``(pairs_per_round, table_cap, min_count)`` configuration: the device
formulations replicate the host's tie-breaking (count desc, pair-id asc),
its [CN07] early-pairs table cap, and its greedy left-to-right overlap
resolution exactly (``tests/test_torch_build.py`` is the gate).

The per-round API (``init_state`` / ``count_pairs`` / ``replace_round``)
exposes the two Re-Pair inner steps on the backend's own state so tests
can diff rounds across backends; ``build_grammar`` runs the fused loop and
``build_index`` carries the result through to the device index layouts
that ``build_flat_index`` / ``build_paged_index`` define.
"""

from __future__ import annotations

import abc
import dataclasses
import os
from typing import Any, Sequence

import numpy as np

from ..core.index import (DEFAULT_PAGE, FlatIndex, PagedIndex,
                          build_flat_index, build_paged_index)
from ..core.repair import RePairResult
from ..kernels import resolve_device

#: Default static rule budget of the device builders (doubles on demand).
#: Overridable via REPRO_RULE_BUDGET so CI can force the multi-round
#: budget-growth path on tiny corpora.
DEFAULT_RULE_BUDGET = int(os.environ.get("REPRO_RULE_BUDGET", "1024"))


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Construction parameters — the same knobs as ``repair_compress``.

    ``rule_budget`` is device-only: the static size of the rule tables a
    round works on.  It is a *starting* budget — builders double it when
    a build outgrows it, so any value is correct.  ``pair_table`` bounds
    the CudaBuilder's candidate table when ``table_cap == 0`` (with a cap,
    the cap itself sizes the table).
    """

    pairs_per_round: int = 64
    table_cap: int = 0
    min_count: int = 2
    max_rules: int | None = None
    exact: bool = False
    rule_budget: int | None = None
    pair_table: int = 4096

    def resolved(self) -> "BuildConfig":
        """Apply the ``exact`` shorthand (pairs_per_round=1, table_cap=0)."""
        if self.exact:
            return dataclasses.replace(self, pairs_per_round=1, table_cap=0,
                                       exact=False)
        return self

    @property
    def budget(self) -> int:
        return self.rule_budget or DEFAULT_RULE_BUDGET


@dataclasses.dataclass
class BuiltIndex:
    """End product of ``Builder.build_index``: the grammar artifacts plus
    the device layouts in the form the query tier consumes."""

    res: RePairResult
    fi: FlatIndex
    pi: PagedIndex | None = None


class Builder(abc.ABC):
    """Backend-pluggable Re-Pair construction over concatenated d-gap
    streams.  ``state`` is backend-defined (numpy arrays for the host,
    tensors on one device for torch/cuda); the numpy boundary of
    ``count_pairs``/``replace_round`` is for cross-backend diffing."""

    name: str = "abstract"

    def __init__(self, config: BuildConfig | None = None, *, device="cuda",
                 **overrides):
        cfg = config or BuildConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg.resolved()
        #: where ``build_index`` puts the index tensors (``"cuda"`` by
        #: default, ``"cpu"`` on request); the device builders build there
        self.device = device

    # -- round-level API -----------------------------------------------------

    @abc.abstractmethod
    def init_state(self, lists: Sequence[np.ndarray]) -> Any:
        """Gap-encode + concatenate the postings and return the backend's
        working state (sequence, separator mask, empty rule tables)."""

    @abc.abstractmethod
    def count_pairs(self, state: Any) -> tuple[np.ndarray, np.ndarray]:
        """Ranked pair histogram of the current sequence: ((K, 2) pairs,
        (K,) counts), sorted by (count desc, pair asc), [CN07]-capped and
        ``min_count``-filtered per the config."""

    @abc.abstractmethod
    def replace_round(self, state: Any, pairs: np.ndarray,
                      new_ids: np.ndarray) -> tuple[Any, np.ndarray]:
        """Replace every non-overlapping occurrence of each chosen pair
        (greedy left-to-right) with its new symbol id.  Returns
        (new_state, per-pair replacement counts)."""

    # -- fused end-to-end ----------------------------------------------------

    @abc.abstractmethod
    def build_grammar(self, lists: Sequence[np.ndarray]) -> RePairResult:
        """Postings -> gap stream -> grammar, to fixpoint (or the config's
        ``max_rules``/``min_count`` stop)."""

    def build_index(self, lists: Sequence[np.ndarray], *, B: int = 8,
                    optimize: bool = False, paged: bool = False,
                    page_size: int = DEFAULT_PAGE) -> BuiltIndex:
        """The full pipeline: postings -> grammar -> FlatIndex (+ paged
        layout) on the builder's ``device``, in the exact tensor layout
        ``build_flat_index`` defines — ready for any engine backend or
        ``QueryServer.rebuild``."""
        res = self.build_grammar(lists)
        if optimize:
            from ..core.optimize import optimize_rules
            res, _ = optimize_rules(res)
        fi = build_flat_index(res, B=B, device=resolve_device(self.device))
        pi = build_paged_index(fi, page_size) if paged else None
        return BuiltIndex(res=res, fi=fi, pi=pi)
