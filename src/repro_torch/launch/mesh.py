"""Mesh construction, the port of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16).  Multi-pod: (pod=2, data=16, model=16);
``pod`` is an outer data axis (gradients reduce over it after ``data``).

The port's :class:`~repro_torch.distributed.Mesh` is driven by one
process, so a mesh may hold more coordinates than there are devices:
:func:`make_production_mesh` lays the devices present out over the grid
in turn (every coordinate on the one card, on a machine with one), while
:func:`make_host_mesh` caps its axes by the devices present, as the
reference caps them by ``len(jax.devices())``.  ``device="meta"`` lays
out meta entries (the dry run's meshes: no memory, no card); only a caller
that names it gets it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..distributed.sharding import Mesh
from ..kernels import resolve_device


def _devices(device) -> list[torch.device]:
    """Every device of ``device``'s kind: the cards present for
    ``"cuda"`` (raises without one), the one CPU for ``"cpu"``, the meta
    device for ``"meta"``."""
    if torch.device(device).type == "meta":
        return [torch.device("meta")]
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    n = math.prod(shape)
    return np.array([devs[i % len(devs)] for i in range(n)],
                    dtype=object).reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid(_devices(device), shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A small (data, model) mesh over however many devices exist."""
    devs = _devices(device)
    n = len(devs)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return Mesh(_grid(devs, (data, model)), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes a global batch shards over: ('pod', 'data') on multi-pod."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"
