"""AdamW as plain tensor code, the reference's law to the op: a cosine LR
schedule with linear warmup, global-norm clipping, and int8 gradient
compression (``compress_int8`` / ``decompress_int8``).

``torch.optim.AdamW`` is not used: it decays every tensor, decays as
``p *= 1 - lr·wd`` where the reference steps ``p -= lr·(step + wd·p)``,
and bias-corrects as ``sqrt(v) / sqrt(b2c)`` where the reference takes
``sqrt(v / b2c)``.

``params`` is a :class:`~repro_torch.models.transformer.Transformer` or a
tree of tensors (GCN's and the recsys models' parameters).  Both are
walked as the reference's pytree (``train/tree.py``), which decides two
things:

* **weight decay goes by the rank of the reference's leaf.**  The
  reference decays a leaf when ``p.ndim >= 2``, and its layer leaves are
  stacked ``(L, ...)``: every layer's ``ln1``, ``ln2``, ``q_norm``,
  ``k_norm``, ``q_a_norm`` and ``kv_a_norm`` is decayed and ``ln_f`` is
  not, though the port's per-block tensors of the former are of rank 1;
* **the global norm** sums per-leaf float32 sums of squares in the
  reference's leaf order (sorted keys), a stacked leaf's sum over its
  blocks.  The order inside a leaf differs, so the norm may differ in its
  last bits.

``adamw_update`` writes the parameters and the moments in place (the
counterpart of the reference's ``donate_argnums``).  The moments are
float32 trees in the reference's layout, a stacked leaf's moments one
``(L, ...)`` tensor; ``init_opt_state_shape`` gives their shapes as meta
tensors (the dry run's).

``compressed_psum_with_feedback`` is the reference's cross-pod gradient
collective, run over per-coordinate gradient trees of a mesh
(``distributed/spmd.py``): the int8 payload is summed exactly and the
scale max-reduced, so a card and the CPU give the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..distributed.spmd import pmax, psum
from .tree import (Stacked, device_of, leaves, leaves_with_paths, parts,
                   rebuild, tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    bf16_update_gather: bool = False
    # ^ the reference's ZeRO-1 lever: the update DELTA is cast to the param
    #   dtype before it is applied (the moments and the update math stay
    #   f32); on one device only the rounding differs


class OptState(NamedTuple):
    mu: Any                  # first moment, fp32, the reference's layout
    nu: Any                  # second moment, fp32
    count: torch.Tensor      # int32 scalar


def _zeros(leaf) -> torch.Tensor:
    return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)


def init_opt_state(params: Any) -> OptState:
    return OptState(mu=tree_map(_zeros, params), nu=tree_map(_zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=device_of(params)))


def init_opt_state_shape(params_shape: Any) -> OptState:
    """The optimizer state's shapes and dtypes as meta tensors (the dry
    run's): float32 moments of the parameters' shapes, an int32 count."""
    def f32(p):
        return torch.empty(tuple(p.shape), dtype=torch.float32, device="meta")

    return OptState(mu=tree_map(f32, params_shape),
                    nu=tree_map(f32, params_shape),
                    count=torch.empty((), dtype=torch.int32, device="meta"))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int or an int32 tensor),
    in the reference's float32 arithmetic (its ``cos`` may differ from
    this one by an ulp)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _global_norm(grad_leaves: list[list[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum, in leaf order, of each leaf's float32 sum of
    squares (a stacked leaf's over its blocks)."""
    return torch.sqrt(sum(sum(g.float().square().sum() for g in gs)
                          for gs in grad_leaves))


def _clip_scale(max_norm: float, gn: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                       max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    gn = _global_norm([parts(g) for g in leaves(grads)])
    scale = _clip_scale(max_norm, gn)
    return tree_map(lambda g: g * scale, grads), gn


def _grad_parts(params: Any, grads: Any) -> list[list[torch.Tensor]]:
    """Each parameter leaf's gradient, per part: the parameters' ``.grad``
    (zeros where none was accumulated) when ``grads`` is None, else the
    matching leaf of ``grads`` (the reference's layout: a stacked leaf's
    gradient ``(L, ...)``)."""
    if grads is None:
        return [[p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in parts(leaf)] for leaf in leaves(params)]
    return [list(g.unbind(0)) if isinstance(leaf, Stacked) else [g]
            for leaf, g in zip(leaves(params), leaves(grads))]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: OptState) -> tuple[Any, OptState, dict]:
    """One AdamW step, written in place into ``params`` and the moments of
    ``state``; returns (params, new state, metrics).  ``grads`` is a tree
    in the reference's layout, or None for the parameters' ``.grad``.
    Gradients stay in their dtype until inside the per-leaf update."""
    p_leaves = list(leaves_with_paths(params))
    g_parts = _grad_parts(params, grads)
    gn = _global_norm(g_parts)
    clip_scale = _clip_scale(cfg.clip_norm, gn)
    count = state.count + 1
    lr = lr_at(cfg, state.count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    for (path, leaf), gs, (mpath, mu), (_, nu) in zip(
            p_leaves, g_parts, leaves_with_paths(state.mu),
            leaves_with_paths(state.nu)):
        if mpath != path:
            raise ValueError(f"moment {mpath} does not match parameter "
                             f"{path}")
        stacked = isinstance(leaf, Stacked)
        ms = mu.unbind(0) if stacked else [mu]
        vs = nu.unbind(0) if stacked else [nu]
        decayed = leaf.ndim >= 2
        for p, g, m, v in zip(parts(leaf), gs, ms, vs):
            g = g.float() * clip_scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if decayed:
                step = step + cfg.weight_decay * p.float()
            if cfg.bf16_update_gather:
                p.sub_((lr * step).to(p.dtype))
            else:
                p.copy_(p.float() - lr * step)
    metrics = {"grad_norm": gn, "lr": lr}
    return params, OptState(state.mu, state.nu, count), metrics


# -- gradient compression (int8 with error feedback) ---------------------------

def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale), the
    scale a 0-d tensor on ``g``'s device.  Both divisions are by device
    tensors: CUDA divides by a host scalar as a product with its
    reciprocal, which can differ from the quotient in the last bit."""
    amax = g.abs().max() + 1e-12
    scale = amax / torch.full((), 127.0, dtype=amax.dtype,
                              device=amax.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_with_feedback(grads: list, errors: list, axis, mesh
                                  ) -> tuple[list, list]:
    """The reference's ``shard_map`` body over a mesh: ``grads`` and
    ``errors`` hold one tree per mesh coordinate (on its device, in the
    mesh's order).  Per leaf, each coordinate quantizes (grad + carried
    error) to int8, the int8 payload is summed over ``axis`` (the slow
    cross-pod hop) and the scales max-reduced, and each coordinate
    dequantizes the sum and carries its residual.  As in the reference,
    the residual is taken against the max-reduced scale:
    ``new_e = target - q * max_scale`` with ``q`` quantized at the local
    scale, so ``out + Σ new_e == Σ target`` while ``new_e`` is not the
    quantization error where the scales differ.  Returns (the reduced
    trees, the new error trees)."""
    g_leaves = [leaves(g) for g in grads]
    e_leaves = [leaves(e) for e in errors]
    outs = [[] for _ in grads]
    errs = [[] for _ in grads]
    for j in range(len(g_leaves[0])):
        targets = [g[j].float() + e[j] for g, e in zip(g_leaves, e_leaves)]
        qs, scales = zip(*(compress_int8(t) for t in targets))
        summed = psum([q.to(torch.int32) for q in qs], axis, mesh)
        scales = pmax(scales, axis, mesh)
        for i, (t, q, s, sc) in enumerate(zip(targets, qs, summed, scales)):
            outs[i].append(s.float() * sc)
            errs[i].append(t - decompress_int8(q, sc))
    return ([rebuild(g, o) for g, o in zip(grads, outs)],
            [rebuild(e, r) for e, r in zip(errors, errs)])
