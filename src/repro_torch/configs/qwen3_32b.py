"""qwen3-32b [dense] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA, head_dim 128 decoupled from d_model.
[hf:Qwen/Qwen3-8B family; hf]"""

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = LMConfig(
    name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64, n_kv=8,
    d_ff=25600, vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

SMOKE = LMConfig(
    name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=256, head_dim=16, qk_norm=True, kv_chunk=32,
    vocab_pad_to=32,
)

ARCH = ArchSpec(name="qwen3-32b", family="lm", config=CONFIG,
                smoke_config=SMOKE, shapes=LM_SHAPES,
                source="hf:Qwen/Qwen3-8B; hf")
