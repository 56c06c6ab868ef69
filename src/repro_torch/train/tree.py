"""Trees of tensors walked in the reference's ``jax.tree_util`` order.

The training tier keeps the reference's pytree conventions so that its
optimizer sums leaves in the same order and its checkpoints carry the same
path names:

* a dict is walked in sorted key order, a list or tuple in index order;
* an ``OptState`` (a ``NamedTuple``) is walked field by field, each field
  named ``.<field>`` as JAX prints a ``GetAttrKey``;
* a :class:`~repro_torch.models.transformer.Transformer` is the
  reference's stacked LM tree (``embed``, ``layers/...``, ``ln_f``,
  ``unembed``): each ``layers/...`` leaf is a :class:`Stacked` list of the
  model's ``L`` per-block tensors, which stands for their stack
  ``(L, ...)``, the leaf of the reference's tree;
* anything else (a tensor) is a leaf.

Paths join the keys with ``/``, as ``repro/train/checkpoint.py`` spells
them (``params/layers/attn/wq``, ``opt/.mu/ln_f``, ``opt/.count``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


class Stacked(list):
    """One leaf of the reference's stacked tree held as the list of its
    ``L`` per-layer tensors (the parameters of the model's blocks)."""

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self), *self[0].shape)

    @property
    def ndim(self) -> int:
        return self[0].ndim + 1

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    @property
    def device(self) -> torch.device:
        return self[0].device

    def stack(self) -> torch.Tensor:
        return torch.stack([t.detach() for t in self])


def is_model(tree) -> bool:
    """A model that names its parameters as the reference's stacked tree
    (a :class:`~repro_torch.models.transformer.Transformer`)."""
    return hasattr(tree, "stacked_leaves")


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list[tuple[str, Any]]:
    if is_model(tree):
        return [(path, Stacked(leaf) if isinstance(leaf, list) else leaf)
                for path, leaf in tree.stacked_leaves()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_leaf(tree) -> bool:
    return isinstance(tree, Stacked) or not (
        is_model(tree) or isinstance(tree, (dict, list, tuple)))


def leaves_with_paths(tree, prefix: str = "", is_leaf: Callable | None = None
                      ) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in ``jax.tree.leaves`` order;
    ``is_leaf`` marks more nodes as leaves (a partition spec, which is a
    tuple itself), as ``jax.tree_util``'s argument of that name."""
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_paths(child, _join(prefix, key), is_leaf)


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def map_with_paths(fn: Callable, tree, prefix: str = ""):
    """``fn(path, node)`` of every leaf and of every model, in a tree of
    the same containers (what ``fn`` returns for a model stands in its
    place)."""
    if is_model(tree) or _is_leaf(tree):
        return fn(prefix, tree)
    kids = [map_with_paths(fn, child, _join(prefix, key))
            for key, child in _children(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), kids))
    return type(tree)(kids)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree):
    """``fn`` of every leaf, in a tree of the same containers.  A model
    maps to the nested dict of the reference's tree (``{"embed": ...,
    "layers": {"attn": {...}, ...}, ...}``)."""

    def one(_, node):
        if not is_model(node):
            return fn(node)
        out: dict = {}
        for path, leaf in _children(node):
            *heads, last = path.split("/")
            at = out
            for h in heads:
                at = at.setdefault(h, {})
            at[last] = fn(leaf)
        return out

    return map_with_paths(one, tree)


def rebuild(tree, values) -> Any:
    """``tree``'s containers with its leaves replaced by ``values``, in
    :func:`leaves` order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def parts(leaf) -> list[torch.Tensor]:
    """The tensors a leaf is held in: a :class:`Stacked` leaf's per-layer
    tensors, else the leaf itself."""
    return list(leaf) if isinstance(leaf, Stacked) else [leaf]


def device_of(tree) -> torch.device:
    """The device of a tree's first leaf (a model's ``embed``)."""
    return leaves(tree)[0].device
