"""granite-moe-3b-a800m [moe] 32L d_model=1536 24H (GQA kv=8, head 64)
d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]

40 experts do not divide the 16-way model axis -> TP inside experts
(d_ff=512 shards 16-way to 32), per DESIGN.md §5."""

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv=8, d_ff=512, vocab=49155, head_dim=64, moe=True, n_experts=40,
    top_k=8, rope_theta=1e4,
)

SMOKE = LMConfig(
    name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=32, vocab=256, head_dim=16, moe=True, n_experts=5, top_k=2,
    kv_chunk=32, vocab_pad_to=32,
)

ARCH = ArchSpec(name="granite-moe-3b-a800m", family="lm", config=CONFIG,
                smoke_config=SMOKE, shapes=LM_SHAPES,
                source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")
