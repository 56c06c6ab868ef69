"""Architecture registry: ``get_arch(name)`` -> ArchSpec.

Each assigned architecture has its exact published config plus a reduced
smoke config (same family, tiny dims) used by CPU tests.
"""

from __future__ import annotations

from .base import ArchSpec, LM_SHAPES, GNN_SHAPES, RECSYS_SHAPES

_REGISTRY = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    if not _REGISTRY:
        _load()
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load()
    return sorted(_REGISTRY)


def _load() -> None:
    from . import (qwen3_32b, yi_6b, minicpm3_4b, granite_moe, phi35_moe,
                   gcn_cora, bert4rec, bst, sasrec, deepfm, repair_ir)
    for mod in (qwen3_32b, yi_6b, minicpm3_4b, granite_moe, phi35_moe,
                gcn_cora, bert4rec, bst, sasrec, deepfm, repair_ir):
        register(mod.ARCH)
