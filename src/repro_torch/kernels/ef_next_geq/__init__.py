"""Kernel K3: Elias-Fano next_geq (``csrc/ef_next_geq.cu``), its operand
pack and plain version."""

from .ops import ef_next_geq, ef_next_geq_plain, next_geq_ef, pad_ef_operands

__all__ = ["ef_next_geq", "ef_next_geq_plain", "next_geq_ef",
           "pad_ef_operands"]
