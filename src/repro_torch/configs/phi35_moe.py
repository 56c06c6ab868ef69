"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

16 experts divide the 16-way model axis exactly -> expert parallelism."""

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv=8, d_ff=6400, vocab=32064, head_dim=128, moe=True, n_experts=16,
    top_k=2, rope_theta=1e4,
)

SMOKE = LMConfig(
    name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=64, vocab=256, head_dim=16, moe=True, n_experts=4, top_k=2,
    kv_chunk=32, vocab_pad_to=32,
)

ARCH = ArchSpec(name="phi3.5-moe-42b-a6.6b", family="lm", config=CONFIG,
                smoke_config=SMOKE, shapes=LM_SHAPES,
                source="hf:microsoft/Phi-3.5-MoE-instruct; hf")
