"""ArchSpec: one architecture + its assigned input-shape set + a reduced
smoke config."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | long_decode | full_graph |
    #                    minibatch | molecule | serve | retrieval
    params: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str        # lm | gnn | recsys | repair_ir
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")


# assigned LM shapes (seq_len × global_batch)
LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    ShapeSpec("long_500k", "long_decode", {"seq": 524288, "batch": 1,
                                           "window": 4096}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "minibatch",
              {"n_nodes": 232_965, "n_edges": 114_615_892,
               "batch_nodes": 1024, "fanouts": (15, 10), "d_feat": 602}),
    ShapeSpec("ogb_products", "full_graph",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeSpec("molecule", "molecule",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 64}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65_536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)
