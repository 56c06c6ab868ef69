"""The mesh, partition specs and the partition rules of every family.

The port of ``repro/distributed/sharding.py``: Megatron-style TP over
``model`` for transformer weights, DP over ``data`` (× ``pod``), ZeRO-1
sharding of optimizer moments, row-sharded embedding tables for recsys,
replicated GCN weights, sequence-sharded KV caches for decode, and the
list-partitioned index (the Re-Pair grammar replicated, everything that
scales with the corpus sharded).  Each rule maps a ``/``-joined parameter
path, a shape and a mesh to a :class:`P`, with the reference's logic to
the test: the substring tests run in its order (``"embed" in path`` comes
first, so ``unembed`` takes ``P("model", None)``).  A rule reads only the
mesh's ``shape`` and ``axis_names``.

:class:`Mesh` is the counterpart of ``jax.sharding.Mesh``: a grid of
devices with named axes, driven by ONE process.  Each grid coordinate is
one shard's placement, and an entry may repeat (``Mesh(["cpu"] * 3)``
runs three shards on the CPU, as ``--xla_force_host_platform_device_count``
gives JAX three host devices; a mesh of repeated ``cuda:0`` entries runs
every shard on one card).  ``Mesh(devices)`` with a flat list is the one
``data`` axis of list-sharded serving.

:func:`shard_tensor` and :func:`unshard` stand for ``NamedSharding`` +
``device_put`` and ``addressable_shards``: a sharded tensor is the list of
its per-coordinate shards, in the mesh's row-major coordinate order, each
on its coordinate's device.  Where that device is the tensor's own, a
shard is a view of the global tensor, so code that runs per coordinate
never writes into its inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, init=False)
class Mesh:
    """Devices on a grid of named axes.  ``devices`` is the grid in
    row-major order (the last axis fastest), one entry per coordinate."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    grid: tuple[int, ...]

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("data",)):
        arr = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"a device grid of shape {arr.shape} needs "
                             f"{arr.ndim} distinct axis names, got "
                             f"{axis_names}")
        object.__setattr__(self, "devices", tuple(
            torch.device(d) for d in arr.reshape(-1)))
        object.__setattr__(self, "axis_names", axis_names)
        object.__setattr__(self, "grid", tuple(arr.shape))

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in axis order, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> list[tuple[int, ...]]:
        """Every coordinate, in the order of ``devices``."""
        return [tuple(int(i) for i in np.unravel_index(k, self.grid))
                for k in range(self.size)]


class P(tuple):
    """A partition spec, the counterpart of ``jax.sharding.PartitionSpec``:
    one entry per leading dimension, each ``None`` (replicated), an axis
    name, or a tuple of names (sharded over their product, the first name
    major).  As JAX stores them, a one-name tuple is stored as the name
    and an empty tuple as ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_total(mesh: Mesh, dp: tuple[str, ...]) -> int:
    return int(np.prod([_axis_size(mesh, a) for a in dp]))


# -- LM param rules -------------------------------------------------------------

def lm_param_spec(path: str, shape: tuple[int, ...], mesh: Mesh,
                  n_experts: int = 0, kv_replicate: bool = False) -> P:
    """``path`` is the ``/``-joined key path.  Layer-stacked params have a
    leading L dim (never sharded).  ``kv_replicate`` keeps wk/wv whole per
    shard (KV-head replication for n_kv < tp).  The tests run in the
    reference's order: ``unembed`` matches ``"embed"`` first, and
    ``"wk"`` matches ``wkv_a`` and ``wkv_b``."""
    tp = _axis_size(mesh, "model")
    if "embed" in path:
        return P("model", None)
    if "unembed" in path:
        return P(None, "model")
    if path.endswith(("ln1", "ln2", "ln_f", "q_norm", "k_norm", "q_a_norm",
                      "kv_a_norm")):
        return P(*([None] * len(shape)))
    if "attn" in path:
        if kv_replicate and any(path.endswith(k) for k in ("wk", "wv")):
            return P(*([None] * len(shape)))
        # (L, d, H*hd) column-parallel; wo (L, H*hd, d) row-parallel
        if any(k in path for k in ("wq", "wk", "wv", "wq_a", "wq_b",
                                   "wkv_a", "wkv_b")):
            return P(None, None, "model")
        if "wo" in path:
            return P(None, "model", None)
    if "ffn" in path:
        if "router" in path:
            return P(None, None, None)
        is_expert = len(shape) == 4  # (L, E, d, f)
        if is_expert:
            if n_experts and n_experts % tp == 0:
                return P(None, "model", None, None)      # expert parallel
            # TP inside experts
            if "w_down" in path:
                return P(None, None, "model", None)
            return P(None, None, None, "model")
        if "w_down" in path:
            return P(None, "model", None)
        return P(None, None, "model")
    return P(*([None] * len(shape)))


def lm_cache_spec(path: str, shape: tuple[int, ...], mesh: Mesh,
                  batch: int) -> P:
    """KV cache (L, B, S, ...): batch over data when divisible, cache
    sequence over model (context parallel decode)."""
    dp = dp_axes(mesh)
    dp_total = _dp_total(mesh, dp)
    bspec: Any = dp if (batch % max(dp_total, 1) == 0 and batch >= dp_total) \
        else None
    return P(None, bspec, "model", *([None] * (len(shape) - 3)))


# -- generic helpers -------------------------------------------------------------

def spec_tree(params: Any, rule: Callable, mesh: Mesh) -> Any:
    """Apply a ``(path, shape, mesh) -> P`` rule over a tree (a
    :class:`~repro_torch.models.transformer.Transformer` is the
    reference's stacked tree, ``train/tree.py``); the result has the
    containers of ``tree_map``'s."""
    from ..train.tree import is_model, map_with_paths, tree_map

    def one(prefix, node):
        if not is_model(node):
            return rule(prefix, tuple(node.shape), mesh)
        return map_with_paths(one, tree_map(lambda leaf: leaf, node),
                              prefix)

    return map_with_paths(one, params)


def zero1_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """ZeRO-1: shard optimizer moments further over the data axes by adding
    'data' (and 'pod') to the first dim that is unsharded and divisible."""
    dp = dp_axes(mesh)
    if not dp:
        return spec
    dp_total = _dp_total(mesh, dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp_total == 0 and dim >= dp_total:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return P(*entries)
        if e is not None and not isinstance(e, tuple) and e == "model":
            continue
    return spec


def batch_spec(mesh: Mesh, ndim: int, batch: int | None = None) -> P:
    """Shard dim 0 over the data axes (replicate if indivisible)."""
    dp = dp_axes(mesh)
    if batch is not None:
        dp_total = _dp_total(mesh, dp)
        if batch % max(dp_total, 1) != 0 or batch < dp_total:
            return P(*([None] * ndim))
    lead: Any = dp if len(dp) > 1 else (dp[0] if dp else None)
    return P(lead, *([None] * (ndim - 1)))


# -- Inverted-index rules ---------------------------------------------------------

#: FlatIndex fields that replicate to every device: the Re-Pair grammar is
#: the paper's "dictionary fits in RAM" structure, so every shard carries
#: a full copy
INDEX_REPLICATED_FIELDS = ("sym_left", "sym_right", "sym_sum", "sym_len")


def index_partition_spec(path: str, shape: tuple[int, ...], mesh: Mesh) -> P:
    """List-partitioned layout for FlatIndex / PagedIndex fields (and
    their stacked per-shard form): grammar tables replicated, everything
    that scales with the corpus (the stream, spans, page directory,
    (b)-sampling tables) sharded on its leading dim across the data axes,
    so the paged stream ``(num_pages, PAGE)`` shards whole pages."""
    name = path.rsplit("/", 1)[-1]
    dp = dp_axes(mesh)
    if name in INDEX_REPLICATED_FIELDS or not dp:
        return P(*([None] * len(shape)))
    lead: Any = dp if len(dp) > 1 else dp[0]
    return P(lead, *([None] * (len(shape) - 1)))


# -- GNN rules -------------------------------------------------------------------

def gnn_param_spec(path: str, shape: tuple[int, ...], mesh: Mesh) -> P:
    # GCN weights are tiny: replicate.
    return P(*([None] * len(shape)))


# -- RecSys rules -----------------------------------------------------------------

def recsys_param_spec(path: str, shape: tuple[int, ...], mesh: Mesh) -> P:
    if any(k in path for k in ("table", "item_emb")) and len(shape) == 2:
        return P("model", None)      # row-sharded embedding tables
    if "mlp_w" in path and len(shape) == 2 and shape[0] % _axis_size(
            mesh, "model") == 0 and shape[0] >= 512:
        return P("model", None)
    return P(*([None] * len(shape)))


# -- shards -------------------------------------------------------------------------

def _parts(spec: P, mesh: Mesh, ndim: int) -> list[int]:
    """The number of blocks of each of ``ndim`` dims under ``spec``; checks
    the spec against the mesh."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than rank {ndim}")
    used = [a for e in spec for a in _names(e)]
    for a in used:
        if a not in mesh.axis_names:
            raise ValueError(f"spec {spec} names {a!r}, not an axis of the "
                             f"mesh {mesh.axis_names}")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} uses an axis twice")
    return [math.prod(mesh.shape[a] for a in _names(spec[d]))
            if d < len(spec) else 1 for d in range(ndim)]


def _blocks(spec: P, mesh: Mesh, ndim: int) -> list[tuple[int, ...]]:
    """Per coordinate, the block index of each of ``ndim`` dims under
    ``spec`` (0 where a dim is replicated)."""
    out = []
    for c in mesh.coords():
        at = dict(zip(mesh.axis_names, c))
        idx = []
        for d in range(ndim):
            b = 0
            for a in _names(spec[d] if d < len(spec) else None):
                b = b * mesh.shape[a] + at[a]
            idx.append(b)
        out.append(tuple(idx))
    return out


def shard_shape(shape: Sequence[int], spec: P, mesh: Mesh
                ) -> tuple[int, ...]:
    """The largest block ``spec`` cuts of a tensor of ``shape`` (the
    counterpart of ``NamedSharding.shard_shape``): each dim split over the
    axes its entry names, rounded up, as JAX pads an uneven shard."""
    return tuple(-(-dim // n) for dim, n in
                 zip(shape, _parts(spec, mesh, len(shape))))


def shard_tensor(x: torch.Tensor, spec: P, mesh: Mesh) -> list[torch.Tensor]:
    """``x``'s shard at every mesh coordinate, in coordinate order, each on
    its coordinate's device: dim ``d`` split into equal blocks over the
    axes ``spec[d]`` names (a view where the device is ``x``'s own)."""
    parts = _parts(spec, mesh, x.ndim)
    for dim, n in zip(x.shape, parts):
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split into {n} shards under {spec}")
    out = []
    for dev, idx in zip(mesh.devices, _blocks(spec, mesh, x.ndim)):
        sl = tuple(slice(b * (dim // n), (b + 1) * (dim // n))
                   for b, dim, n in zip(idx, x.shape, parts))
        out.append(x[sl].to(dev))
    return out


def unshard(shards: Sequence[torch.Tensor], spec: P, mesh: Mesh,
            device=None) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the global tensor on
    ``device`` (by default the first shard's), concatenated from the
    shards at coordinate 0 of every axis ``spec`` does not name (a
    replicated shard is read once)."""
    ndim = shards[0].ndim
    device = shards[0].device if device is None else torch.device(device)
    parts = _parts(spec, mesh, ndim)
    used = {a for e in spec for a in _names(e)}
    free = [i for i, a in enumerate(mesh.axis_names) if a not in used]
    by_block = {}
    for s, c, idx in zip(shards, mesh.coords(),
                         _blocks(spec, mesh, ndim)):
        if all(c[i] == 0 for i in free):
            by_block[idx] = s

    def build(prefix: tuple[int, ...]) -> torch.Tensor:
        d = len(prefix)
        if d == ndim:
            return by_block[prefix].to(device)
        if parts[d] == 1:
            return build(prefix + (0,))
        return torch.cat([build(prefix + (b,)) for b in range(parts[d])],
                         dim=d)

    return build(())
