"""Kernel K6: row-wise d-gap decode (``csrc/gap_decode.cu``) and its plain
version."""

from .ops import gap_decode, gap_decode_plain

__all__ = ["gap_decode", "gap_decode_plain"]
