"""Pipeline parallelism (GPipe schedule) over a ``stage`` mesh axis, the
port of ``repro/distributed/pipeline.py``.

* the stacked per-layer params (L, ...) shard over ``stage``: each of the
  S stages owns L/S contiguous layers on its coordinate's device;
* the batch splits into M microbatches; at clock tick t, stage s runs
  microbatch (t - s) if 0 <= t - s < M, then passes its activation to
  stage s+1 (``spmd.ppermute``);
* the last stage's outputs are collected microbatch by microbatch; the
  pipeline drains after M + S - 1 ticks.  Bubble fraction is the usual
  (S-1)/(M+S-1).

As in the reference, every stage runs every tick (ticks where a stage has
no work process values that are never read), so a mesh whose stages share
one device does (M + S - 1)/M of the sequential model's work.  Gradients
flow through autograd: the shards are views of the stacked params and the
hops are ``.to`` copies.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import resolve_device
from ..train.tree import leaves, rebuild
from .sharding import Mesh, P, shard_tensor
from .spmd import axis_index, ppermute


def pipeline_apply(mesh: Mesh, stage_axis: str, n_microbatches: int,
                   stage_fn: Callable, params, x: torch.Tensor
                   ) -> torch.Tensor:
    """Run ``y = stage_fn(stage_params, x)`` through all S stages.

    params: tree whose leaves are (L, ...) stacked per-layer tensors,
            sharded P(stage_axis) — each coordinate sees (L/S, ...);
    stage_fn(local_params, x) -> x applies ONE STAGE's layers;
    x: (B, ...) global batch, replicated across ``stage``.
    Returns y: (B, ...), the final stage's value, on ``x``'s device.
    """
    S = mesh.shape[stage_axis]
    M = n_microbatches
    B = x.shape[0]
    assert B % M == 0, (B, M)
    mb = B // M
    n = mesh.size

    sh = [shard_tensor(leaf, P(stage_axis), mesh) for leaf in leaves(params)]
    p_locs = [rebuild(params, [s[i] for s in sh]) for i in range(n)]
    sid = [axis_index(mesh, stage_axis, i) for i in range(n)]
    perm = [(i, (i + 1) % S) for i in range(S)]
    mbs = [xr.reshape(M, mb, *x.shape[1:])
           for xr in shard_tensor(x, P(), mesh)]
    carry = [torch.zeros_like(m[0]) for m in mbs]
    outs: list[list] = [[None] * M for _ in range(n)]

    for t in range(M + S - 1):
        ys = []
        for i in range(n):
            # stage 0 injects microbatch t from the replicated input
            x_in = mbs[i][min(t, M - 1)] if sid[i] == 0 else carry[i]
            y = stage_fn(p_locs[i], x_in)
            # the last stage stores microbatch (t - (S-1)) when valid
            m_out = t - (S - 1)
            if sid[i] == S - 1 and 0 <= m_out < M:
                outs[i][m_out] = y
            ys.append(y)
        # pass activations down the pipe (last->first wraps; the wrapped
        # value is never read by stage 0, which injects)
        carry = ppermute(ys, stage_axis, perm, mesh)

    last = sid.index(S - 1)
    return torch.cat(outs[last]).reshape(B, *x.shape[1:]).to(x.device)


def stack_mlp_params(generator: torch.Generator, n_layers: int, d: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Demo/test model: L × (dense + relu) with residual, drawn from
    ``generator`` (which lives on ``device``)."""
    dev = resolve_device(device)
    w = torch.stack([torch.randn((d, d), generator=generator, dtype=dtype,
                                 device=dev) * (0.5 / d ** 0.5)
                     for _ in range(n_layers)])
    b = torch.zeros((n_layers, d), dtype=dtype, device=dev)
    return {"w": w, "b": b}


def mlp_stage_fn(p_loc: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply this stage's L/S layers in order."""
    for w, b in zip(p_loc["w"], p_loc["b"]):
        x = x + torch.relu(x @ w + b)
    return x


def mlp_reference(params: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_stage_fn(params, x)
