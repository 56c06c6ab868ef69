"""Core of the port: host Re-Pair construction, samplings and cursor
structures (numpy, copied from the JAX package), and the torch device
indexes (``index``)."""

from .repair import (Grammar, RePairResult, repair_compress,
                     repair_result_from_arrays, repair_result_to_arrays)
from .sampling import ASampling, BSampling, build_a_sampling, build_b_sampling
from . import intersect

__all__ = ["Grammar", "RePairResult", "repair_compress",
           "repair_result_from_arrays", "repair_result_to_arrays",
           "ASampling", "BSampling", "build_a_sampling", "build_b_sampling",
           "intersect"]
