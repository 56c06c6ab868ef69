"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym.
[arXiv:1609.02907; paper]

The d_feat/n_classes of the *model* follow the shape being lowered
(cora 1433/7; ogbn-products 100/47; reddit-minibatch 602/41; molecule 64)."""

from ..models.gnn import GCNConfig
from .base import ArchSpec, GNN_SHAPES

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, d_feat=1433,
                   n_classes=7, aggregator="mean")

SMOKE = GCNConfig(name="gcn-smoke", n_layers=2, d_hidden=8, d_feat=32,
                  n_classes=4, aggregator="sym")

ARCH = ArchSpec(name="gcn-cora", family="gnn", config=CONFIG,
                smoke_config=SMOKE, shapes=GNN_SHAPES,
                source="arXiv:1609.02907; paper")
