"""Kernel K7: domain-bucketed intersection (``csrc/bucket_intersect.cu``),
its plain version and the host bucket layout."""

from .ops import (INT_INF, bucket_intersect, bucket_intersect_plain,
                  bucketize, unbucketize)

__all__ = ["INT_INF", "bucket_intersect", "bucket_intersect_plain",
           "bucketize", "unbucketize"]
