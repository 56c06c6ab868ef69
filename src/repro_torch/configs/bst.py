"""bst [recsys] embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq (Behavior Sequence
Transformer, Alibaba).  [arXiv:1905.06874; paper]"""

from ..models.recsys import SeqRecConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = SeqRecConfig(name="bst", n_items=1_048_576, embed_dim=32,
                      n_blocks=1, n_heads=8, seq_len=20, causal=False,
                      mlp_dims=(1024, 512, 256))

SMOKE = SeqRecConfig(name="bst-smoke", n_items=512, embed_dim=16,
                     n_blocks=1, n_heads=4, seq_len=8, causal=False,
                     mlp_dims=(64, 32))

ARCH = ArchSpec(name="bst", family="recsys", config=CONFIG,
                smoke_config=SMOKE, shapes=RECSYS_SHAPES,
                source="arXiv:1905.06874; paper")
