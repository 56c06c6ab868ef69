"""Multi-device layout of the port: the single-process
:class:`~repro_torch.distributed.sharding.Mesh` that list-sharded serving
runs over, and the index fields every shard replicates."""

from .sharding import INDEX_REPLICATED_FIELDS, Mesh

__all__ = ["INDEX_REPLICATED_FIELDS", "Mesh"]
