"""Distribution in one process: the :class:`~.sharding.Mesh` of named
device axes (list-sharded serving runs over its one ``data`` axis), the
partition specs and rules of every family with the shards they cut
(``sharding``), ``shard_map``'s collectives over per-coordinate tensors
(``spmd``), and GPipe over a ``stage`` axis (``pipeline``)."""

from .sharding import (INDEX_REPLICATED_FIELDS, Mesh, P, batch_spec, dp_axes,
                       gnn_param_spec, index_partition_spec, lm_cache_spec,
                       lm_param_spec, recsys_param_spec, shard_tensor,
                       spec_tree, unshard, zero1_spec)

__all__ = ["INDEX_REPLICATED_FIELDS", "Mesh", "P", "batch_spec", "dp_axes",
           "gnn_param_spec", "index_partition_spec", "lm_cache_spec",
           "lm_param_spec", "recsys_param_spec", "shard_tensor", "spec_tree",
           "unshard", "zero1_spec"]
