"""Roofline terms of a dry-run cell, the port of
``repro/launch/hlo_analysis.py``.

The reference reads its terms from a compiled XLA artifact: FLOPs and
bytes from ``cost_analysis()``, collective traffic parsed from the
optimized HLO text.  The port's dry run (``launch/dryrun.py``) has no
compiled artifact: it counts FLOPs and bytes by tracing the cell's step on
the meta device and counts its collectives from the partition rules, then
builds the same :class:`RooflineTerms` with :func:`roofline_from_counts`.
:func:`parse_collectives` is kept, the reference's parser of HLO text:
``tests/test_torch_dryrun.py`` reads the reference's compiled programs
with it to hold the dry run's collectives beside XLA's.  Both count wire
bytes through one set of ring formulas
(:meth:`CollectiveStats.add_collective`), per participating device:

  all-reduce          2 · out_bytes · (k-1)/k
  all-gather          out_bytes · (k-1)/k      (output = gathered size)
  reduce-scatter      out_bytes · (k-1)        (input = k · output)
  all-to-all          out_bytes · (k-1)/k
  collective-permute  out_bytes                (point-to-point)

k is the group size (from ``replica_groups`` in HLO text).

Hardware model: the NVIDIA H100 SXM's published peaks at its full power
limit of 700 W — 989 TFLOP/s dense bf16, 3.35 TB/s of HBM, and NVLink at
450 GB/s each way between the cards of one host.  The production meshes
(16 × 16 = 256 cards, 2 × 16 × 16 = 512) span 32 and 64 hosts of 8 cards,
so traffic that leaves a host would run at the network's rate; this
model, like the reference's single link rate, does not separate the two.
"""

from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 989e12         # bf16 dense, per card
HBM_BW = 3.35e12            # bytes/s per card
NVLINK_BW = 450e9           # bytes/s per card, each way

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# result shape of an HLO op:  "%name = bf16[4,128]{1,0} all-gather(...)"
_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([\d,]*)\][^)]*?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", )
_TUPLE_COLLECTIVE_RE = re.compile(
    r"=\s*\((.*?)\)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # iota form [num_groups,group_size]<=[total]
        return int(m.group(2))
    return default


def wire_bytes(op: str, out_bytes: float, k: int) -> float:
    """Per-device wire bytes of one collective ``op`` whose output is
    ``out_bytes`` per device, over a group of ``k`` devices."""
    if op == "all-reduce":
        return 2.0 * out_bytes * (k - 1) / k
    if op in ("all-gather", "all-to-all"):
        return out_bytes * (k - 1) / k
    if op == "reduce-scatter":
        return float(out_bytes * (k - 1))
    if op == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0            # per-device, summed over ops
    op_counts: dict = dataclasses.field(default_factory=dict)
    op_bytes: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, b: float, n: float = 1) -> None:
        self.wire_bytes += b
        self.op_counts[op] = self.op_counts.get(op, 0) + n
        self.op_bytes[op] = self.op_bytes.get(op, 0.0) + b

    def add_collective(self, op: str, out_bytes: float, k: int,
                       n: float = 1) -> None:
        """``n`` collectives ``op`` of ``out_bytes`` output per device over
        groups of ``k`` (none is counted when ``k`` <= 1)."""
        if k > 1 and n:
            self.add(op, n * wire_bytes(op, out_bytes, k), n)

    def merge(self, other: "CollectiveStats") -> None:
        for op, n in other.op_counts.items():
            self.add(op, other.op_bytes[op], n)


def parse_collectives(hlo_text: str, num_devices: int) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue  # paired with -start; count once
        m = _COLLECTIVE_RE.search(line)
        shapes: list[tuple[str, str]] = []
        op = None
        if m:
            op = m.group(3)
            shapes = [(m.group(1), m.group(2))]
        else:
            mt = _TUPLE_COLLECTIVE_RE.search(line)
            if mt:
                op = mt.group(2)
                shapes = _SHAPE_RE.findall(mt.group(1))
        if not op:
            continue
        out_bytes = sum(_shape_bytes(d, s) for d, s in shapes)
        stats.add_collective(op, out_bytes, _group_size(line, num_devices))
    return stats


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs of the step
    hbm_bytes: float             # per-device bytes read and written
    wire_bytes: float            # per-device collective wire bytes
    num_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0     # 6·N·D useful flops (LM families)
    useful_ratio: float = 0.0    # model_flops / (flops · num_devices)
    collectives: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "collectives": self.collectives,
        }


def roofline_from_counts(flops: float, hbm_bytes: float,
                         stats: CollectiveStats, num_devices: int,
                         model_flops: float = 0.0) -> RooflineTerms:
    """The terms of a step that does ``flops`` and moves ``hbm_bytes`` per
    device and whose collectives are ``stats`` (per device);
    ``model_flops`` is the whole step's, so the useful ratio divides by
    ``num_devices``."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = stats.wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm_bytes, wire_bytes=stats.wire_bytes,
        num_devices=num_devices, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * num_devices) if flops else 0.0),
        collectives={k: {"count": stats.op_counts[k],
                         "wire_bytes": stats.op_bytes[k]}
                     for k in stats.op_counts},
    )
