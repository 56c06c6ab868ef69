"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq.  [arXiv:1904.06690; paper]

Item vocabulary set to 1M rows (the retrieval_cand shape scores 1M
candidates; production-scale tables per kernel_taxonomy §RecSys)."""

from ..models.recsys import SeqRecConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = SeqRecConfig(name="bert4rec", n_items=1_048_576, embed_dim=64,
                      n_blocks=2, n_heads=2, seq_len=200, causal=False,
                      n_neg=512)

SMOKE = SeqRecConfig(name="bert4rec-smoke", n_items=512, embed_dim=16,
                     n_blocks=2, n_heads=2, seq_len=16, causal=False,
                     n_neg=16)

ARCH = ArchSpec(name="bert4rec", family="recsys", config=CONFIG,
                smoke_config=SMOKE, shapes=RECSYS_SHAPES,
                source="arXiv:1904.06690; paper")
