"""Kernel K2: block-max page-entry decode of ranked retrieval
(``csrc/page_score.cu``), its operand pack and plain version."""

from .ops import page_decode, page_score, page_score_plain

__all__ = ["page_decode", "page_score", "page_score_plain"]
