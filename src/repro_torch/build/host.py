"""HostBuilder: the paper's offline numpy construction behind the Builder
API (a copy of ``repro/build/host.py``).

``build_grammar`` IS ``core.repair.repair_compress`` (same code path, same
output, bit for bit) — this backend exists so consumers can address the
host loop through the same seam as the device builders, and so the parity
tests have their oracle.  The round-level methods re-expose the two numpy
inner steps (``_pair_counts_capped`` / ``_replace_pairs_batch``) on an
explicit state object.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.repair import (RePairResult, _pair_counts_capped,
                           _replace_pairs_batch, lists_to_gap_stream,
                           repair_compress)
from .base import Builder


@dataclasses.dataclass
class HostBuildState:
    """The host loop's working set: the (separator-remapped) symbol
    sequence and its active mask, plus the bookkeeping the final
    RePairResult assembly needs."""

    seq: np.ndarray
    active: np.ndarray
    num_terminals: int
    firsts: np.ndarray
    lens: np.ndarray
    universe: int
    rules: list[tuple[int, int]] = dataclasses.field(default_factory=list)


class HostBuilder(Builder):
    """The numpy loop; ``device`` only says where ``build_index`` puts the
    index tensors."""

    name = "host"

    def init_state(self, lists: Sequence[np.ndarray]) -> HostBuildState:
        stream, firsts, lens, universe = lists_to_gap_stream(lists)
        sep = stream == -1
        max_gap = int(stream[~sep].max(initial=0))
        seq = stream.copy()
        seq[sep] = np.arange(int(sep.sum()), dtype=np.int64)
        active = ~sep
        return HostBuildState(seq=seq, active=active,
                              num_terminals=max_gap + 1, firsts=firsts,
                              lens=lens, universe=universe)

    def count_pairs(self, state: HostBuildState
                    ) -> tuple[np.ndarray, np.ndarray]:
        pairs, counts = _pair_counts_capped(state.seq, state.active,
                                            self.config.table_cap)
        good = counts >= self.config.min_count
        return pairs[good], counts[good]

    def replace_round(self, state: HostBuildState, pairs: np.ndarray,
                      new_ids: np.ndarray
                      ) -> tuple[HostBuildState, np.ndarray]:
        seq, active, counts = _replace_pairs_batch(
            state.seq, state.active, np.asarray(pairs, dtype=np.int64),
            np.asarray(new_ids, dtype=np.int64))
        return dataclasses.replace(state, seq=seq, active=active), counts

    def build_grammar(self, lists: Sequence[np.ndarray]) -> RePairResult:
        cfg = self.config
        return repair_compress(lists, max_rules=cfg.max_rules,
                               min_count=cfg.min_count,
                               pairs_per_round=cfg.pairs_per_round,
                               table_cap=cfg.table_cap)
