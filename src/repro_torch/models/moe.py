"""Mixture-of-Experts FFN with top-k token-choice routing.

Dispatch is the capacity-bounded scatter formulation (GShard semantics,
static shapes, no (T, E, C) one-hot cube), grouped: tokens are reshaped
(G, T/G, d), so ranking, capacity and scatter are local to a group.  Per
group, tokens are ranked within their expert by a cumulative sum in token
order, scattered into a (G, E, C, d) buffer, processed by batched expert
GEMMs, and combined back weighted by their gate.  Overflowing tokens go to
slot C, which is dropped (Switch behavior; the aux loss pushes the router
toward balance).

With a mesh and a tensor-parallel axis, :func:`moe_ffn` routes to
:func:`moe_ffn_sharded`, the reference's ``shard_map`` dispatch run once
per mesh coordinate (``distributed/spmd.py``): each data shard ranks its
own tokens (capacity C = cf·k·Tl/E per data shard), each model shard
computes its experts (expert parallel when E %% tp == 0) or its slice of
every expert's hidden dim (tensor parallel inside the experts), and one
``psum`` over the model axis combines them.  Both paths share the router
and the expert products (float32 products of the bf16 operands, as the
reference's CPU path computes them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import Mesh, P, shard_tensor, unshard
from ..distributed.spmd import axis_index, per_coordinate, psum
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


def _route(xg: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router of tokens grouped (G, Tg, d): float32 gates (G, Tg, E) and
    the top-k gates, renormalised, with their experts (G, Tg, k)."""
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(gates, top_k)
    return gates, top_vals / top_vals.sum(dim=-1, keepdim=True), top_idx


def _rank(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, slot)'s rank within its expert's queue, in token order
    along the last axis of ``flat_e``."""
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=-2, dtype=torch.int32) * onehot
    return pos_in_e.sum(dim=-1, dtype=torch.int32) - 1


def _experts(xin: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The expert GEMMs over the dispatch buffer (G, E, C, d) in float32
    (the reference's CPU path upcasts its operands; an f32-accumulated
    bf16 product has the same values), rounded to ``xin``'s dtype."""
    g = torch.einsum("gecd,edf->gecf", xin.float(), w_gate.float())
    u = torch.einsum("gecd,edf->gecf", xin.float(), w_up.float())
    h = (F.silu(g) * u).to(xin.dtype)
    return torch.einsum("gecf,efd->gecd", h.float(),
                        w_down.float()).to(xin.dtype)


def _local_dispatch_ffn(p_locs: list[dict], x_locs: list[torch.Tensor], *,
                        mesh: Mesh, n_experts: int, top_k: int,
                        capacity_factor: float, e_base: list[int],
                        e_local: int, dp_axes_t: tuple, tp_axis
                        ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The reference's per-device MoE body, run for every mesh coordinate
    (lists in the mesh's order, each coordinate on its device; the two
    collectives run over the lists).

    ``x_locs[i]`` (Tl, d) is coordinate i's data shard of the tokens
    (replicated over the model axis); ``p_locs[i]`` its expert slice.
    Each coordinate dispatches ONLY to its ``e_local`` experts
    [e_base, e_base + e_local), computes the expert GEMMs and weights the
    outputs; the partial outputs are summed over the model axis.  Capacity
    is per (data shard, expert): C = cf·k·Tl/E_route.  Returns each
    coordinate's (out, aux)."""
    Tl, d = x_locs[0].shape
    E = n_experts                             # dispatch id space (padded)
    E_route = p_locs[0]["router"].shape[-1]   # real experts, router-scored
    C = max(1, int(capacity_factor * top_k * Tl / E_route))
    routes = [_route(x[None], p["router"], top_k)
              for p, x in zip(p_locs, x_locs)]

    # aux loss over GLOBAL tokens: the local sums summed over the data axes
    me = [g[0].sum(dim=0) for g, _, _ in routes]
    ce = [F.one_hot(i[0, :, 0], E_route).float().sum(dim=0)
          for _, _, i in routes]
    cnt = [torch.full((), float(Tl), device=x.device) for x in x_locs]
    if dp_axes_t:
        me, ce, cnt = (psum(v, dp_axes_t, mesh) for v in (me, ce, cnt))
    aux = [E_route * torch.sum((m / c) * (e / c))
           for m, e, c in zip(me, ce, cnt)]

    parts = []
    for p, x, (_, top_vals, top_idx), base in zip(p_locs, x_locs, routes,
                                                  e_base):
        flat_e = top_idx.reshape(-1)                              # (Tk,)
        flat_g = top_vals.reshape(-1)
        pos = _rank(flat_e, E)
        keep = pos < C
        # route only to this coordinate's experts; the rest -> overflow
        rel_e = flat_e - base
        mine = keep & (rel_e >= 0) & (rel_e < e_local)
        rel_e_c = torch.where(mine, rel_e, 0)
        slot = torch.where(mine, pos, C).long()
        tok = torch.arange(Tl, device=x.device).repeat_interleave(top_k)
        buf = torch.zeros((e_local, C + 1, d), dtype=x.dtype,
                          device=x.device)
        buf.index_put_((rel_e_c, slot), x[tok], accumulate=True)
        y = _experts(buf[None, :, :C, :], p["w_gate"], p["w_up"],
                     p["w_down"])[0]                              # (El, C, d)
        y_pad = torch.cat([y, torch.zeros((e_local, 1, d), dtype=y.dtype,
                                          device=y.device)], dim=1)
        picked = y_pad[rel_e_c, slot]                             # (Tk, d)
        picked = picked * (flat_g[:, None] * mine[:, None]).to(picked.dtype)
        parts.append(picked.reshape(Tl, top_k, d).sum(dim=1))
    # combine expert shards: the ONE collective the MoE layer pays
    return psum(parts, tp_axis, mesh), aux


def moe_ffn_sharded(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
                    capacity_factor: float, mesh: Mesh, dp_spec, tp_axis,
                    ep_pad: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` MoE: explicit local dispatch and one
    psum, over ``mesh`` in one process.  Returns (out (T, d), aux) on
    ``x``'s device.

    Expert placement: E %% tp == 0 -> expert parallelism (each model shard
    owns E/tp experts); otherwise every shard holds all experts with the
    FFN hidden dim sharded (TP inside experts) and the psum reduces the
    partial down-projections.  ``ep_pad`` instead pads the expert dim with
    zero experts up to a multiple of tp and runs expert parallel; the
    router still scores only the E real experts.  A token count that does
    not split over the data axes (single-lane decode) is replicated over
    them: every data shard runs the same dispatch.
    """
    E = n_experts
    tp = mesh.shape[tp_axis]
    if ep_pad and E % tp != 0:
        E_pad = -(-E // tp) * tp

        def pad_e(w):
            return torch.cat([w, torch.zeros((E_pad - E,) + w.shape[1:],
                                             dtype=w.dtype, device=w.device)])

        p = {"router": p["router"], "w_gate": pad_e(p["w_gate"]),
             "w_up": pad_e(p["w_up"]), "w_down": pad_e(p["w_down"])}
        E = E_pad
    ep = E % tp == 0
    dp_axes_t = dp_spec if isinstance(dp_spec, tuple) else (
        (dp_spec,) if dp_spec else ())
    dp_total = 1
    for a in dp_axes_t:
        dp_total *= mesh.shape[a]
    if x.shape[0] % max(dp_total, 1) != 0:
        dp_spec = None
        dp_axes_t = ()

    if ep:
        pspecs = {"router": P(None, None), "w_gate": P(tp_axis, None, None),
                  "w_up": P(tp_axis, None, None),
                  "w_down": P(tp_axis, None, None)}
        e_local = E // tp
    else:
        pspecs = {"router": P(None, None), "w_gate": P(None, None, tp_axis),
                  "w_up": P(None, None, tp_axis),
                  "w_down": P(None, tp_axis, None)}
        e_local = E
    shards = {k: shard_tensor(p[k], pspecs[k], mesh) for k in pspecs}
    p_locs = [{k: v[i] for k, v in shards.items()} for i in range(mesh.size)]
    xspec = P(dp_spec, None)
    e_base = [axis_index(mesh, tp_axis, i) * e_local if ep else 0
              for i in range(mesh.size)]
    x_locs = shard_tensor(x, xspec, mesh)
    with per_coordinate(mesh):
        out, aux = _local_dispatch_ffn(
            p_locs, x_locs, mesh=mesh, n_experts=E, top_k=top_k,
            capacity_factor=capacity_factor, e_base=e_base,
            e_local=e_local, dp_axes_t=dp_axes_t, tp_axis=tp_axis)
    return unshard(out, xspec, mesh, x.device), aux[0].to(x.device)


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, num_groups: int = 1,
            dp_spec=None, tp_axis=None, mesh: Mesh | None = None,
            ep_pad: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux_loss scalar).  T = flattened tokens.

    With ``mesh`` and ``tp_axis`` set, dispatch runs through
    :func:`moe_ffn_sharded`, as in the reference.  Otherwise the grouped
    path below runs; ``num_groups`` G must divide T (else one group), the
    local capacity is C = max(1, int(cf·k·T/(G·E))).  The reference pins
    this path's intermediates to ``dp_spec`` / ``tp_axis`` with sharding
    constraints, which fix a layout and change no value: here the two
    compute nothing."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"moe_ffn: mesh must be a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh is not None and tp_axis is not None:
        return moe_ffn_sharded(p, x, n_experts=n_experts, top_k=top_k,
                               capacity_factor=capacity_factor, mesh=mesh,
                               dp_spec=dp_spec, tp_axis=tp_axis,
                               ep_pad=ep_pad)
    T, d = x.shape
    E = n_experts
    G = num_groups if num_groups > 0 and T % num_groups == 0 else 1
    Tg = T // G
    C = max(1, int(capacity_factor * top_k * Tg / E))
    dev = x.device

    xg = x.reshape(G, Tg, d)
    gates, top_vals, top_idx = _route(xg, p["router"], top_k)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e, global means
    me = gates.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(top_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # per-group expert queues: rank each (token, slot) within its expert
    flat_e = top_idx.reshape(G, Tg * top_k)                  # (G, Tk)
    flat_g = top_vals.reshape(G, Tg * top_k)
    pos = _rank(flat_e, E)                                   # (G, Tk)
    keep = pos < C
    slot = torch.where(keep, pos, C).long()                  # drop -> C

    # scatter tokens into (G, E, C+1, d); row C is the overflow bin
    tok = torch.arange(Tg, device=dev).repeat_interleave(top_k)   # (Tk,)
    src = xg[:, tok, :]                                      # (G, Tk, d)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tg * top_k)
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((gidx, flat_e, slot), src, accumulate=True)
    xin = buf[:, :, :C, :]                                   # (G, E, C, d)

    y = _experts(xin, p["w_gate"], p["w_up"], p["w_down"])

    # gather back: token t sums gate * y[g, e, slot] over its kept slots
    y_pad = torch.cat([y, torch.zeros((G, E, 1, d), dtype=y.dtype,
                                      device=dev)], dim=2)
    picked = y_pad[gidx, flat_e, slot]                       # (G, Tk, d)
    picked = picked * flat_g[..., None].to(picked.dtype) * \
        keep[..., None].to(picked.dtype)
    out = picked.reshape(G, Tg, top_k, d).sum(dim=2)         # (G, Tg, d)
    return out.reshape(T, d), aux
