"""Mixture-of-Experts FFN with top-k token-choice routing.

Dispatch is the capacity-bounded scatter formulation (GShard semantics,
static shapes, no (T, E, C) one-hot cube), grouped: tokens are reshaped
(G, T/G, d), so ranking, capacity and scatter are local to a group.  Per
group, tokens are ranked within their expert by a cumulative sum in token
order, scattered into a (G, E, C, d) buffer, processed by batched expert
GEMMs, and combined back weighted by their gate.  Overflowing tokens go to
slot C, which is dropped (Switch behavior; the aux loss pushes the router
toward balance).

This is the reference's single-device path.  Its expert-parallel
``shard_map`` path (``moe_ffn_sharded``) belongs to the distribution slice;
until then :func:`moe_ffn` refuses a mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Dtype, randn_scaled


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype=Dtype, device="cpu") -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {
        "router": randn_scaled(generator, (d_model, n_experts), s, torch.float32,
                          device),
        "w_gate": randn_scaled(generator, (n_experts, d_model, d_ff), s, dtype,
                          device),
        "w_up": randn_scaled(generator, (n_experts, d_model, d_ff), s, dtype,
                        device),
        "w_down": randn_scaled(generator, (n_experts, d_ff, d_model),
                          1.0 / math.sqrt(d_ff), dtype, device),
    }


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, ties broken by the lower index (``jax.lax.top_k``'s order): a
    stable descending sort, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, num_groups: int = 1,
            tp_axis=None, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux_loss scalar).  T = flattened tokens.

    ``num_groups`` G must divide T (else one group); the local capacity is
    C = max(1, int(cf·k·T/(G·E))).  ``mesh`` / ``tp_axis`` select the
    reference's sharded dispatch, which is not ported yet: given either,
    this raises."""
    if mesh is not None or tp_axis is not None:
        raise NotImplementedError(
            "moe_ffn: the sharded (mesh / tp_axis) dispatch is not ported; "
            "the single-device path takes neither")
    T, d = x.shape
    E = n_experts
    G = num_groups if num_groups > 0 and T % num_groups == 0 else 1
    Tg = T // G
    C = max(1, int(capacity_factor * top_k * Tg / E))
    dev = x.device

    xg = x.reshape(G, Tg, d)
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)                    # (G, Tg, E)
    top_vals, top_idx = _top_k(gates, top_k)                 # (G, Tg, k)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e, global means
    me = gates.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(top_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # per-group expert queues: rank each (token, slot) within its expert
    flat_e = top_idx.reshape(G, Tg * top_k)                  # (G, Tk)
    flat_g = top_vals.reshape(G, Tg * top_k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)            # (G, Tk, E)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot
    pos = pos_in_e.sum(dim=-1, dtype=torch.int32) - 1        # (G, Tk)
    keep = pos < C
    slot = torch.where(keep, pos, C).long()                  # drop -> C

    # scatter tokens into (G, E, C+1, d); row C is the overflow bin
    tok = torch.arange(Tg, device=dev).repeat_interleave(top_k)   # (Tk,)
    src = xg[:, tok, :]                                      # (G, Tk, d)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tg * top_k)
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((gidx, flat_e, slot), src, accumulate=True)
    xin = buf[:, :, :C, :]                                   # (G, E, C, d)

    # the expert GEMMs in float32 (the reference's CPU path upcasts its
    # operands; an f32-accumulated bf16 product has the same values)
    g = torch.einsum("gecd,edf->gecf", xin.float(), p["w_gate"].float())
    u = torch.einsum("gecd,edf->gecf", xin.float(), p["w_up"].float())
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("gecf,efd->gecd", h.float(),
                     p["w_down"].float()).to(x.dtype)

    # gather back: token t sums gate * y[g, e, slot] over its kept slots
    y_pad = torch.cat([y, torch.zeros((G, E, 1, d), dtype=y.dtype,
                                      device=dev)], dim=2)
    picked = y_pad[gidx, flat_e, slot]                       # (G, Tk, d)
    picked = picked * flat_g[..., None].to(picked.dtype) * \
        keep[..., None].to(picked.dtype)
    out = picked.reshape(G, Tg, top_k, d).sum(dim=2)         # (G, Tg, d)
    return out.reshape(T, d), aux
