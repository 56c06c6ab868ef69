"""GCN [Kipf & Welling, arXiv:1609.02907] with segment-sum message passing.

Message passing is a scatter-add over the edge index (``index_add_`` in
place of the reference's ``jax.ops.segment_sum``), for three input
regimes:

* full-graph   — one big (N, F) feature matrix + (E, 2) edge index
                 (cora / ogbn-products shapes),
* minibatch    — layer-sampled subgraphs from a REAL host-side CSR
                 neighbor sampler (fanout 15/10, GraphSAGE-style),
* molecule     — batched small dense graphs via a per-graph offset trick
                 (segment ids shifted per graph, one flat scatter-add).

Symmetric normalization Â = D^-1/2 (A+I) D^-1/2 is precomputed per edge
(``norm`` array) when aggregator="sym"; aggregator="mean" divides by
in-degree instead.  Parameters are a tree ``{"w": [...], "b": [...]}`` of
float32 tensors, as in the reference.  ``edge_norm_for``, ``CSRGraph`` and
``sample_subgraph`` are numpy, copies of the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    aggregator: str = "mean"      # "mean" | "sym"
    dropout: float = 0.0


def init_params(cfg: GCNConfig, generator: torch.Generator,
                device="cpu") -> dict:
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {
        "w": [torch.randn((dims[i], dims[i + 1]), generator=generator,
                          device=device) * (1.0 / math.sqrt(dims[i]))
              for i in range(cfg.n_layers)],
        "b": [torch.zeros((dims[i + 1],), device=device)
              for i in range(cfg.n_layers)],
    }


def gcn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor, edge_norm: torch.Tensor,
              n_nodes: int, last: bool) -> torch.Tensor:
    """x (N, F) -> (N, F'); aggregate-then-transform (cheaper when F > F')."""
    msgs = x[src.long()] * edge_norm[:, None]
    agg = torch.zeros((n_nodes, x.shape[1]), dtype=msgs.dtype,
                      device=x.device).index_add_(0, dst.long(), msgs)
    h = agg @ w + b
    return h if last else torch.relu(h)


def forward(params: dict, cfg: GCNConfig, feats: torch.Tensor,
            src: torch.Tensor, dst: torch.Tensor,
            edge_norm: torch.Tensor) -> torch.Tensor:
    n = feats.shape[0]
    x = feats
    for i in range(cfg.n_layers):
        x = gcn_layer(x, params["w"][i], params["b"][i], src, dst, edge_norm,
                      n, last=(i == cfg.n_layers - 1))
    return x


def loss_fn(params: dict, cfg: GCNConfig, feats, src, dst, edge_norm,
            labels, label_mask) -> torch.Tensor:
    logits = forward(params, cfg, feats, src, dst, edge_norm)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    nll = (lse - gold) * label_mask
    return torch.sum(nll) / torch.clamp(torch.sum(label_mask), min=1.0)


def edge_norm_for(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                  aggregator: str) -> np.ndarray:
    """Precompute per-edge normalization on host."""
    deg_in = np.bincount(dst, minlength=n_nodes).astype(np.float32)
    if aggregator == "mean":
        return 1.0 / np.maximum(deg_in[dst], 1.0)
    deg_out = np.bincount(src, minlength=n_nodes).astype(np.float32)
    return 1.0 / np.sqrt(np.maximum(deg_out[src], 1.0) *
                         np.maximum(deg_in[dst], 1.0))


# -- host-side CSR neighbor sampler (minibatch regime) ------------------------

class CSRGraph:
    """Host CSR adjacency for neighbor sampling."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """Uniform with-replacement sample: (len(nodes), fanout) neighbor ids
        (self-loop fallback for isolated nodes)."""
        out = np.empty((nodes.size, fanout), dtype=np.int64)
        for i, v in enumerate(nodes):
            lo, hi = self.offsets[v], self.offsets[v + 1]
            if hi > lo:
                out[i] = self.nbr[rng.integers(lo, hi, size=fanout)]
            else:
                out[i] = v
        return out


def sample_subgraph(graph: CSRGraph, seed_nodes: np.ndarray,
                    fanouts: list[int], rng: np.random.Generator
                    ) -> list[np.ndarray]:
    """Layer-wise sampling (GraphSAGE): frontier l+1 is the flat neighbor
    sample of frontier l — element i of frontier l+1 is a sampled neighbor
    of element i // fanout of frontier l.  That implicit bipartite structure
    makes the device-side aggregation a static reshape+mean (no ragged
    segment ids needed in the sampled regime).  Returns the frontiers
    (node-id arrays), deepest last."""
    frontiers = [seed_nodes.astype(np.int64)]
    for f in fanouts:
        nbrs = graph.sample_neighbors(frontiers[-1], f, rng)  # (T, f)
        frontiers.append(nbrs.reshape(-1))
    return frontiers


def minibatch_forward(params: dict, cfg: GCNConfig,
                      deepest_feats: torch.Tensor,
                      fanouts: list[int]) -> torch.Tensor:
    """deepest_feats (B * prod(fanouts), F) — features of the deepest
    frontier; aggregate inward: reshape (T, fanout, F) -> mean -> linear."""
    x = deepest_feats
    for i, f in enumerate(reversed(fanouts)):
        x = x.reshape(-1, f, x.shape[-1]).mean(dim=1)
        h = x @ params["w"][i] + params["b"][i]
        x = h if i == cfg.n_layers - 1 else torch.relu(h)
    return x
