"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq.  [arXiv:1808.09781; paper]"""

from ..models.recsys import SeqRecConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = SeqRecConfig(name="sasrec", n_items=1_048_576, embed_dim=50,
                      n_blocks=2, n_heads=1, seq_len=50, causal=True,
                      n_neg=512)

SMOKE = SeqRecConfig(name="sasrec-smoke", n_items=512, embed_dim=16,
                     n_blocks=2, n_heads=1, seq_len=12, causal=True,
                     n_neg=16)

ARCH = ArchSpec(name="sasrec", family="recsys", config=CONFIG,
                smoke_config=SMOKE, shapes=RECSYS_SHAPES,
                source="arXiv:1808.09781; paper")
