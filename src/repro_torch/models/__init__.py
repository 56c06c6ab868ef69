"""Model zoo: the 10 assigned architectures (5 LM transformers incl. MoE and
MLA, 1 GNN, 4 recsys) in PyTorch.  The LM is an ``nn.Module``
(``transformer.Transformer``); GCN and the recsys models are functions of
parameter trees, as in the reference.  ``convert`` carries the
reference's parameters across."""
