"""Segmented log-structured index: streaming ingestion for the serving
tier (DESIGN.md §12).  A copy of ``repro/segment`` for the port.

The paper's data structure is static; this package makes it *refreshable
at document granularity* the way log-structured engines do:

* a RAM **delta tier** absorbs ``insert(doc)`` with immediate query
  visibility (an inverted dict over the mutation-log tail — no
  compression on the write path);
* when the delta exceeds ``REPRO_DELTA_BUDGET`` documents it is flushed
  into an **immutable Re-Pair segment** through the backend-pluggable
  build subsystem (``repro_torch.build``) — SPIMI-style: segments
  partition the document space into contiguous id ranges, so per-segment
  answers concatenate into the global answer with one base offset;
* **generational compaction** merges runs of small same-generation
  segments into bigger ones as a background step the scheduler runs
  between ticks — queries in flight hold an immutable snapshot of the
  segment set, so compaction never blocks them;
* queries run per segment through the SAME step machines as the static
  tier (``QueryExecutor.lower`` / ``lower_topk``), each round tagged with
  its segment's engine so multi-segment traffic coalesces in the
  scheduler per (engine, algo) like any other round; BM25 stays exact
  under ingestion because global idf / document-length statistics are
  maintained incrementally and every segment's block-max directory is
  refreshed against them per stats epoch.
"""

from .manager import (DEFAULT_COMPACT_FANOUT, DELTA_BUDGET_ENV, GlobalStats,
                      Segment, SegmentedIndex, SegmentView)

__all__ = ["SegmentedIndex", "Segment", "SegmentView", "GlobalStats",
           "DELTA_BUDGET_ENV", "DEFAULT_COMPACT_FANOUT"]
