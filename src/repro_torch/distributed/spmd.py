"""``shard_map``'s collectives in one process.

The reference writes its distributed bodies with ``shard_map``: one
program that every device of the mesh runs on its own shard, with
collectives over named axes.  The port keeps one process (a card's
machine has one GPU, and ranks there could not run past one).  A body
becomes code that runs once per mesh coordinate, each coordinate on its
own device, and a sharded value is the list of the coordinates' tensors
in the mesh's coordinate order (:func:`~.sharding.shard_tensor`).  The
collectives below are plain functions over such lists:

* :func:`psum` and :func:`pmax` reduce over the coordinates that differ
  only along the named axes (a *group*) and give every member the result
  on its own device.  A group is reduced in coordinate order, the first
  member's tensor plus the second's plus the third's, on the first
  member's device.  On the CPU this fixed order is what makes the parity
  tests exact where the values allow it (integer payloads, maxima, sums
  with zeros).
* :func:`ppermute` sends each coordinate's tensor to the coordinate whose
  index along the axis the permutation names; a coordinate no pair sends
  to receives zeros, as in JAX.
* :func:`axis_index` is a coordinate's index along an axis.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .sharding import Mesh


def _axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_index(mesh: Mesh, axis: str, i: int) -> int:
    """The index along ``axis`` of the ``i``-th coordinate."""
    return mesh.coords()[i][mesh.axis_names.index(axis)]


def groups(mesh: Mesh, axes) -> list[list[int]]:
    """The coordinates (as positions in the mesh's order) grouped by their
    indices on every axis but ``axes``; each group in coordinate order."""
    axes = _axes(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"{a!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
    keep = [k for k, a in enumerate(mesh.axis_names) if a not in axes]
    out: dict[tuple, list[int]] = {}
    for i, c in enumerate(mesh.coords()):
        out.setdefault(tuple(c[k] for k in keep), []).append(i)
    return list(out.values())


def _reduce(xs: Sequence[torch.Tensor], axes, mesh: Mesh, op
            ) -> list[torch.Tensor]:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size}")
    out: list = [None] * mesh.size
    for g in groups(mesh, axes):
        acc = xs[g[0]]
        for j in g[1:]:
            acc = op(acc, xs[j].to(acc.device))
        for j in g:
            out[j] = acc.to(mesh.devices[j])
    return out


def psum(xs: Sequence[torch.Tensor], axes, mesh: Mesh) -> list[torch.Tensor]:
    """Sum over ``axes`` (a name or a tuple of names; none: the inputs)."""
    return _reduce(xs, axes, mesh, torch.add)


def pmax(xs: Sequence[torch.Tensor], axes, mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise maximum over ``axes``."""
    return _reduce(xs, axes, mesh, torch.maximum)


def ppermute(xs: Sequence[torch.Tensor], axis: str, perm, mesh: Mesh
             ) -> list[torch.Tensor]:
    """Each coordinate at index ``src`` along ``axis`` sends its tensor to
    the coordinate at index ``dst`` of the same group, for every
    ``(src, dst)`` in ``perm``; the others receive zeros."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size}")
    k = mesh.axis_names.index(axis)
    coords = mesh.coords()
    out: list = [None] * mesh.size
    for g in groups(mesh, axis):
        at = {coords[i][k]: i for i in g}
        for src, dst in perm:
            out[at[dst]] = xs[at[src]].to(mesh.devices[at[dst]])
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
