"""The mesh of list-sharded serving, and the index fields it replicates.

The port of the inverted-index part of ``repro/distributed/sharding.py``:
the Re-Pair grammar replicates to every device, and everything that
scales with the corpus (stream, spans, (b)-sampling tables) is
list-partitioned across the one ``data`` axis.

:class:`Mesh` is the counterpart of ``jax.sharding.Mesh`` as serving uses
it: one process drives every shard, each entry of ``devices`` is one
shard's placement along ``data``, and an entry may repeat
(``Mesh(["cpu"] * 3)`` runs three shards on the CPU, as
``--xla_force_host_platform_device_count`` gives JAX three host
devices).

The multi-axis partition rules (``index_partition_spec``, ``dp_axes``)
and the parameter rules of the LM, ZeRO, GNN and recsys families
partition model weights; they come with the model scaffolding (roadmap
item 15(c)), which is their first caller.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True, init=False)
class Mesh:
    """The devices of the ``data`` axis, one shard each, in shard order."""

    devices: tuple[torch.device, ...]

    def __init__(self, devices: Sequence):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


#: FlatIndex fields that replicate to every device: the Re-Pair grammar is
#: the paper's "dictionary fits in RAM" structure, so every shard carries
#: a full copy
INDEX_REPLICATED_FIELDS = ("sym_left", "sym_right", "sym_sum", "sym_len")
