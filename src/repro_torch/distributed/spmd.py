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

Inside :func:`recording`, each collective also reports itself (its kind,
the axes it runs over and the per-coordinate tensors), and a body runs
inside :func:`per_coordinate`, which names its mesh: that is how the dry
run counts a body it traces on the meta device (each op of a body is one
coordinate's work).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from .sharding import Mesh

_RECORDERS: list[Callable] = []


@contextlib.contextmanager
def recording(fn: Callable):
    """Within the block, every :func:`psum` and :func:`pmax` calls
    ``fn("all-reduce", axes, xs, mesh)`` and every :func:`ppermute`
    ``fn("collective-permute", (axis,), xs, mesh)``, ``xs`` the
    per-coordinate inputs."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)


_BODIES: list[Mesh] = []


@contextlib.contextmanager
def per_coordinate(mesh: Mesh):
    """Marks a body that runs once per coordinate of ``mesh``, each time
    on that coordinate's own tensors; :func:`body_mesh` is ``mesh``
    within it."""
    _BODIES.append(mesh)
    try:
        yield
    finally:
        _BODIES.pop()


def body_mesh() -> Mesh | None:
    """The mesh of the innermost :func:`per_coordinate` body, or None."""
    return _BODIES[-1] if _BODIES else None


def _note(op: str, axes, xs, mesh: Mesh) -> None:
    for fn in _RECORDERS:
        fn(op, _axes(axes), xs, mesh)


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
    _note("all-reduce", axes, xs, mesh)
    return _reduce(xs, axes, mesh, torch.add)


def pmax(xs: Sequence[torch.Tensor], axes, mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise maximum over ``axes``."""
    _note("all-reduce", axes, xs, mesh)
    return _reduce(xs, axes, mesh, torch.maximum)


def ppermute(xs: Sequence[torch.Tensor], axis: str, perm, mesh: Mesh
             ) -> list[torch.Tensor]:
    """Each coordinate at index ``src`` along ``axis`` sends its tensor to
    the coordinate at index ``dst`` of the same group, for every
    ``(src, dst)`` in ``perm``; the others receive zeros."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size}")
    _note("collective-permute", axis, xs, mesh)
    k = mesh.axis_names.index(axis)
    coords = mesh.coords()
    out: list = [None] * mesh.size
    for g in groups(mesh, axis):
        at = {coords[i][k]: i for i in g}
        for src, dst in perm:
            out[at[dst]] = xs[at[src]].to(mesh.devices[at[dst]])
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
