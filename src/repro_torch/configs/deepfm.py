"""deepfm [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm.
[arXiv:1703.04247; paper]

Criteo-like heterogeneous field vocabularies: 3 huge fields (4M rows), 6
large (262k), the rest small — 12.8M total rows, padded so the
concatenated table splits evenly 16-way."""

from ..models.recsys import DeepFMConfig
from .base import ArchSpec, RECSYS_SHAPES

_VOCABS = tuple([4_194_304] * 3 + [262_144] * 6 + [65_536] * 10
                + [4_096] * 10 + [256] * 10)
assert len(_VOCABS) == 39
assert sum(_VOCABS) % 512 == 0

CONFIG = DeepFMConfig(name="deepfm", n_fields=39, embed_dim=10,
                      mlp_dims=(400, 400, 400), field_vocabs=_VOCABS)

SMOKE = DeepFMConfig(name="deepfm-smoke", n_fields=8, embed_dim=4,
                     mlp_dims=(32, 16), field_vocabs=tuple([64] * 8))

ARCH = ArchSpec(name="deepfm", family="recsys", config=CONFIG,
                smoke_config=SMOKE, shapes=RECSYS_SHAPES,
                source="arXiv:1703.04247; paper")
