"""Kernel K5: positional phrase expansion (``csrc/grammar_expand.cu``) and
its plain version."""

from .ops import PHRASE_CAP, TILE_W, grammar_expand, grammar_expand_plain

__all__ = ["PHRASE_CAP", "TILE_W", "grammar_expand", "grammar_expand_plain"]
