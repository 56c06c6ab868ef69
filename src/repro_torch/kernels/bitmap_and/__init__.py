"""Kernel K8: bitmap AND and its popcount (``csrc/bitmap_and.cu``), with
their plain versions."""

from .ops import (bitmap_and, bitmap_and_count, bitmap_and_count_plain,
                  bitmap_and_plain, popcount32)

__all__ = ["bitmap_and", "bitmap_and_count", "bitmap_and_count_plain",
           "bitmap_and_plain", "popcount32"]
