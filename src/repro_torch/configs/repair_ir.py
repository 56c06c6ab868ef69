"""repair-ir — the paper's own "architecture": a batched conjunctive-query
serving tier over the Re-Pair compressed inverted index (DESIGN.md §2).

The device workload is the flattened query engine
(``engine.torch_backend`` and the paged ``list_intersect`` kernel):
fixed trip-count next_geq / membership / pairwise-intersection over the
int32 grammar + paged C arrays.  Shapes follow a production search tier:

* ``serve_members``  — 1M (list, docid) membership probes per step,
* ``serve_pairs``    — 64k pairwise list intersections (short expanded to
                       <=256 elements, svs against the long list),
* ``decode_bulk``    — bulk list decompression (gap_decode regime).

The config parameterizes the *synthetic* index the engine is lowered
against (the dry-run needs only its array shapes, not its contents).
"""

from __future__ import annotations

import dataclasses

from .base import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class RepairIRConfig:
    name: str
    num_lists: int = 1 << 20         # 1M vocabulary terms
    c_len: int = 1 << 26             # 64M compressed symbols
    num_symbols: int = 1 << 22       # dense terminals + rules
    num_buckets: int = 1 << 23       # flattened (b)-sampling entries
    max_scan: int = 16               # static bucket-scan bound
    max_depth: int = 24              # §5.1: heights 15-25 -> static 24
    max_short_len: int = 256         # svs short-list expansion cap
    universe: int = 1 << 25          # document-id space
    page_size: int = 2048            # paged-stream page (DESIGN.md §2.5)


CONFIG = RepairIRConfig(name="repair-ir")

SMOKE = RepairIRConfig(name="repair-ir-smoke", num_lists=64, c_len=4096,
                       num_symbols=1024, num_buckets=512, max_scan=8,
                       max_depth=12, max_short_len=32, universe=4096,
                       page_size=512)

REPAIR_SHAPES = (
    ShapeSpec("serve_members", "ir_members", {"batch": 1 << 20}),
    ShapeSpec("serve_pairs", "ir_pairs", {"batch": 1 << 16}),
    ShapeSpec("decode_bulk", "ir_decode", {"rows": 1 << 14, "cols": 1 << 12}),
)

ARCH = ArchSpec(name="repair-ir", family="repair_ir", config=CONFIG,
                smoke_config=SMOKE, shapes=REPAIR_SHAPES,
                source="this paper (CS.IR 2009)")
