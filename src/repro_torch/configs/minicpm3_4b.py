"""minicpm3-4b [dense] 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, DeepSeek-V2 style: q_lora 768, kv_lora 256,
nope 64 + rope 32, v 64).  [hf:openbmb/MiniCPM3-4B; hf]"""

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = LMConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40, n_kv=40,
    d_ff=6400, vocab=73448, attn="mla", q_lora_rank=768, kv_lora_rank=256,
    nope_dim=64, rope_dim=32, v_dim=64, rope_theta=1e4,
)

SMOKE = LMConfig(
    name="minicpm3-4b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256, attn="mla", q_lora_rank=32, kv_lora_rank=16,
    nope_dim=16, rope_dim=8, v_dim=16, kv_chunk=32, vocab_pad_to=32,
)

ARCH = ArchSpec(name="minicpm3-4b", family="lm", config=CONFIG,
                smoke_config=SMOKE, shapes=LM_SHAPES,
                source="hf:openbmb/MiniCPM3-4B; hf")
