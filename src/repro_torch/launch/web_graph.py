"""Re-Pair compressed adjacency lists feeding GCN message passing — the
paper's own lineage ([CN07] compressed Web graphs; adjacency lists ARE
inverted lists) and the gcn-cora arch-applicability demonstration; the
port's counterpart of ``examples/web_graph.py``.

The graph's per-node out-neighbor lists are Re-Pair compressed exactly
like posting lists (the ``torch`` builder, on the device); message
passing decodes them back to an edge index on the device
(``engine.torch_backend.expand_batch``) and runs a GCN over it.  The run
is on the card unless ``--device cpu`` is given; without a card it raises.

  PYTHONPATH=src python -m repro_torch.launch.web_graph [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..build import make_builder
from ..core.dictionary import build_forest
from ..core.index import INT_INF
from ..engine import torch_backend as TB
from ..kernels import resolve_device
from ..models import gnn as G

#: the example's GCN over the decoded graph
GCN = G.GCNConfig(name="web-gcn", n_layers=2, d_hidden=16, d_feat=32,
                  n_classes=8, aggregator="sym")


def make_web_graph(n_nodes=600, seed=0):
    """Preferential-attachment-ish digraph: hubs + locality (compressible
    adjacency, like real Web graphs)."""
    rng = np.random.default_rng(seed)
    adj = []
    for v in range(n_nodes):
        deg = 1 + rng.zipf(1.6) % 40
        # mix: local window links (compressible) + global hub links
        local = v + 1 + rng.integers(0, 20, deg)
        hubs = rng.integers(0, max(v, 1), max(deg // 3, 1))
        nbrs = np.unique(np.concatenate([local, hubs]) % n_nodes)
        nbrs = nbrs[nbrs != v]
        adj.append(nbrs if nbrs.size else np.asarray([(v + 1) % n_nodes]))
    return adj


def decoded_edges(fi, n: int, max_deg: int) -> tuple[np.ndarray, np.ndarray]:
    """Every node's list expanded on the device to (n, max_deg) ids padded
    with ``INT_INF``, then the edge index (src, dst) on the host."""
    mat = TB.expand_batch(fi, torch.arange(n, dtype=torch.int32,
                                           device=fi.starts.device),
                          max_deg).cpu().numpy()
    valid = mat != int(INT_INF)
    return np.repeat(np.arange(n), valid.sum(1)), mat[valid]


def gcn_logits(params: dict, feats: np.ndarray, src: np.ndarray,
               dst: np.ndarray, device) -> torch.Tensor:
    """``GCN`` forward over the edge index on ``device`` (symmetric
    normalization precomputed on the host)."""
    n = feats.shape[0]
    norm = G.edge_norm_for(src, dst, n, GCN.aggregator)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return G.forward(params, GCN, on(feats), on(src.astype(np.int32)),
                     on(dst.astype(np.int32)), on(norm))


def main(device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    n = 600
    adj = make_web_graph(n)
    n_edges = sum(len(a) for a in adj)
    print(f"web graph: {n} nodes, {n_edges} edges")

    # --- compress adjacency with Re-Pair (the [CN07] use-case), on the
    # device build pipeline: gap stream -> grammar -> FlatIndex ---
    built = make_builder("torch", device=dev).build_index(adj)
    res, fi = built.res, built.fi
    bits = build_forest(res.grammar).size_bits(res.seq.size)
    plain = n_edges * int(np.ceil(np.log2(n)))
    print(f"adjacency: plain {plain/8:.0f} B -> re-pair {bits/8:.0f} B "
          f"({bits/plain:.2%}), {res.grammar.num_rules} rules "
          f"(torch builder)")

    # --- decode on device to an edge index ---
    max_deg = max(len(a) for a in adj)
    src, dst = decoded_edges(fi, n, max_deg)
    if src.size != n_edges:
        raise SystemExit(f"decoded {src.size} edges, expected {n_edges}")
    for v in (0, n // 2, n - 1):  # decoded adjacency matches
        np.testing.assert_array_equal(np.sort(dst[src == v]), adj[v])
    print(f"device-decoded edge index: {src.size} edges (verified)")

    # --- GCN forward over the decoded graph ---
    params = G.init_params(GCN, torch.Generator(dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(n, GCN.d_feat)).astype(np.float32)
    logits = gcn_logits(params, feats, src, dst, dev)
    if logits.shape != (n, GCN.n_classes) or bool(torch.isnan(logits).any()):
        raise SystemExit(f"GCN logits {tuple(logits.shape)} or NaN")
    print(f"GCN forward over compressed-then-decoded graph: "
          f"logits {tuple(logits.shape)}, no NaNs")
    print("\nweb_graph OK")
    return logits


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
