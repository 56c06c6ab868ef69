"""yi-6b [dense] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA.  [arXiv:2403.04652; hf]"""

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5e6,
)

SMOKE = LMConfig(
    name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=160, vocab=256, head_dim=16, kv_chunk=32, vocab_pad_to=32,
)

ARCH = ArchSpec(name="yi-6b", family="lm", config=CONFIG, smoke_config=SMOKE,
                shapes=LM_SHAPES, source="arXiv:2403.04652; hf")
