"""Per-(architecture × shape) step functions, input meta tensors and
partition specs for the production dry run; the port of
``repro/launch/specs.py``.

For every cell this module returns a :class:`LoweringSpec`:

* ``fn``            — the step the dry run traces (the ``Trainer``'s train
                      step / ``prefill`` / ``decode_step`` / retrieval /
                      the ir engine's program),
* ``args``          — trees of meta tensors (the reference's
                      ``ShapeDtypeStruct`` trees: shapes and dtypes, never
                      allocated); an LM's parameters are a
                      :class:`~repro_torch.models.transformer.Transformer`
                      on the meta device, walked as the reference's stacked
                      tree (``train/tree.py``),
* ``in_shardings`` / ``out_shardings`` — trees of :class:`P` matching
                      ``args`` and the outputs, over ``mesh`` (the
                      reference's ``NamedSharding`` trees are these specs
                      bound to its mesh).

Conventions (the reference's):

* batch dims shard over ('pod','data') when present, else 'data';
* LM params: Megatron TP over 'model' (+ vocab over 'model'); KV caches
  shard the *cache sequence* over 'model' (context-parallel decode);
* MoE: expert-parallel over 'model' when E %% tp == 0, else TP inside
  experts;
* GNN: nodes/edges shard over the data axes, weights replicated;
* RecSys: embedding tables row-shard over 'model', batch over data axes;
* repair-ir: the FlatIndex arrays are replicated (the grammar is the
  "dictionary fits in RAM" asset); query batches shard over the data axes.

``unroll`` is accepted for the reference's signature: the port's layer and
chunk loops are Python loops, unrolled either way.  As in the reference,
the repair-ir cells trace the plain flattened engine (:func:`_ir_next_geq`),
not the ``list_intersect`` kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..configs.base import ArchSpec, ShapeSpec
from ..distributed.sharding import (Mesh, P, batch_spec, dp_axes,
                                    lm_cache_spec, lm_param_spec,
                                    recsys_param_spec, spec_tree, zero1_spec)
from ..models import gnn as G
from ..models import recsys as R
from ..models import transformer as T
from ..train.loop import _trainable, make_train_step
from ..train.optimizer import AdamWConfig, OptState, init_opt_state_shape
from ..train.tree import leaves_with_paths, tree_map

INT_INF = 2**31 - 1
TRAIN_KINDS = frozenset({"train", "full_graph", "minibatch", "molecule"})


@dataclasses.dataclass
class LoweringSpec:
    fn: Callable
    args: tuple
    in_shardings: Any            # trees of P matching ``args``
    out_shardings: Any           # trees of P matching ``fn``'s outputs
    donate_argnums: tuple = ()   # state buffers updated in place (params/
    #                              opt in train, KV cache in decode)
    mesh: Mesh | None = None
    kind: str = ""               # the cell's shape kind

    @property
    def trains(self) -> bool:
        """Whether the step is a training step (it returns its updated
        parameters and optimizer state)."""
        return self.kind in TRAIN_KINDS


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _replicated(tree) -> Any:
    return tree_map(lambda t: P(*([None] * t.ndim)), tree)


def _dp_total(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))


def _zero1_tree(pshape, rule: Callable, mesh: Mesh) -> OptState:
    """The moments' specs: ``zero1_spec`` of each parameter's spec."""
    def moment(p, s, m):
        return zero1_spec(rule(p, s, m), s, m)

    specs = spec_tree(pshape, moment, mesh)
    return OptState(mu=specs, nu=specs, count=P())


def _train_fn(loss: Callable, opt_cfg: AdamWConfig) -> Callable:
    """The ``Trainer``'s step: ``loss(params, batch)``, ``backward`` (each
    LM layer recomputed), ``adamw_update`` in place.  Returns (params,
    opt_state, metrics)."""
    step = make_train_step(loss, opt_cfg)

    def train_step(params, opt_state, *batch):
        return step(_trainable(params), opt_state,
                    batch[0] if len(batch) == 1 else batch)

    return train_step


_METRICS = {k: P() for k in ("grad_norm", "lr", "loss")}


# =============================================================================
# LM family
# =============================================================================

def _lm_cfg_for_shape(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                      unroll: bool = False,
                      n_layers_override: int | None = None,
                      variant: str = "baseline") -> T.LMConfig:
    cfg: T.LMConfig = arch.config
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    if shape.kind == "long_decode":
        cfg = dataclasses.replace(cfg, window=shape.params["window"])
    dp = dp_axes(mesh)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    # MoE dispatch groups = the data-parallel extent when it divides the
    # token count (decode at tiny batch falls back to fewer groups).
    tokens = shape.params["batch"] * shape.params.get("seq", 1)
    if shape.kind in ("decode", "long_decode"):
        tokens = shape.params["batch"]
    groups = _dp_total(mesh)
    while tokens % groups != 0:
        groups //= 2
    cfg = dataclasses.replace(cfg, dp_spec=dp_spec, tp_axis="model",
                              sp_axis="model", unroll_layers=unroll,
                              moe_groups=max(groups, 1), mesh=mesh)
    if variant == "opt":  # the reference's beyond-baseline flags
        # ep_pad only for train/prefill: at decode batch the per-layer
        # weight-padding concat dominates the tiny step
        ep = shape.kind in ("train", "prefill")
        cfg = dataclasses.replace(cfg, bf16_combine=True,
                                  flash_p_bf16=True, moe_ep_pad=ep)
    return cfg


def _lm_rule(cfg: T.LMConfig, mesh: Mesh, variant: str) -> Callable:
    # "opt-kvrep": replicate wk/wv when kv heads < tp (KV-head replication)
    kv_rep = (variant == "opt-kvrep" and cfg.attn == "gqa"
              and cfg.n_kv < mesh.shape["model"])

    def rule(p, s, m):
        return lm_param_spec(p, s, m, n_experts=cfg.n_experts,
                             kv_replicate=kv_rep)

    return rule


def _lm_param_shardings(cfg: T.LMConfig, mesh: Mesh,
                        variant: str = "baseline"):
    """(the parameters on the meta device, their specs, the rule)."""
    pshape = T.init_params_shape(cfg)
    rule = _lm_rule(cfg, mesh, variant)
    return pshape, spec_tree(pshape, rule, mesh), rule


def _lm_loss(model, batch):
    return model.lm_loss(batch["tokens"], batch["targets"])


def lm_train_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                  unroll: bool = False,
                  n_layers_override: int | None = None,
                  variant: str = "baseline") -> LoweringSpec:
    cfg = _lm_cfg_for_shape(arch, shape, mesh, unroll, n_layers_override,
                            variant)
    B, S = shape.params["batch"], shape.params["seq"]
    pshape, pspecs, rule = _lm_param_shardings(cfg, mesh, variant)
    oshape = init_opt_state_shape(pshape)
    bspec = batch_spec(mesh, 2, B)
    batch = {"tokens": _meta((B, S)), "targets": _meta((B, S))}
    opt_cfg = AdamWConfig(bf16_update_gather=cfg.bf16_combine)
    ospecs = _zero1_tree(pshape, rule, mesh)
    return LoweringSpec(
        fn=_train_fn(_lm_loss, opt_cfg),
        args=(pshape, oshape, batch),
        in_shardings=(pspecs, ospecs, {k: bspec for k in batch}),
        out_shardings=(pspecs, ospecs, dict(_METRICS)),
        donate_argnums=(0, 1), mesh=mesh, kind=shape.kind)


def _cache_specs(cache: dict, mesh: Mesh, B: int) -> dict:
    return {k: lm_cache_spec("", tuple(v.shape), mesh, B)
            for k, v in cache.items()}


def _cache_args(cfg: T.LMConfig, B: int, s_cache: int) -> dict:
    return {k: _meta(s, dt)
            for k, (s, dt) in T.init_cache_shape(cfg, B, s_cache).items()}


def _prefill(model, tokens):
    return model.prefill(tokens)


def _decode(model, token, cache, position):
    return model.decode_step(token, cache, position)


def lm_prefill_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                    unroll: bool = False,
                    n_layers_override: int | None = None,
                    variant: str = "baseline") -> LoweringSpec:
    cfg = _lm_cfg_for_shape(arch, shape, mesh, unroll, n_layers_override,
                            variant)
    B, S = shape.params["batch"], shape.params["seq"]
    pshape, pspecs, _ = _lm_param_shardings(cfg, mesh, variant)
    cspecs = _cache_specs(_cache_args(cfg, B, S), mesh, B)
    return LoweringSpec(
        fn=_prefill, args=(pshape, _meta((B, S))),
        in_shardings=(pspecs, batch_spec(mesh, 2, B)),
        out_shardings=(batch_spec(mesh, 2, B), cspecs), mesh=mesh,
        kind=shape.kind)


def lm_decode_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                   unroll: bool = False,
                   n_layers_override: int | None = None,
                   variant: str = "baseline") -> LoweringSpec:
    cfg = _lm_cfg_for_shape(arch, shape, mesh, unroll, n_layers_override,
                            variant)
    B = shape.params["batch"]
    # long_500k decodes against a ring cache of ``window`` slots — the
    # sub-quadratic path; decode_32k against the full 32k cache.
    s_cache = (cfg.window if shape.kind == "long_decode"
               else shape.params["seq"])
    pshape, pspecs, _ = _lm_param_shardings(cfg, mesh, variant)
    cache = _cache_args(cfg, B, s_cache)
    cspecs = _cache_specs(cache, mesh, B)
    vspec = batch_spec(mesh, 1, B)
    return LoweringSpec(
        fn=_decode, args=(pshape, _meta((B,)), cache, _meta((B,))),
        in_shardings=(pspecs, vspec, cspecs, vspec),
        out_shardings=(batch_spec(mesh, 2, B), cspecs),
        donate_argnums=(2,), mesh=mesh, kind=shape.kind)


# =============================================================================
# GNN family
# =============================================================================

_GNN_SHAPE_DIMS = {
    # shape -> (d_feat, n_classes)
    "full_graph_sm": (1433, 7),
    "minibatch_lg": (602, 41),
    "ogb_products": (100, 47),
    "molecule": (64, 16),
}


def _gnn_cfg_for_shape(arch: ArchSpec, shape: ShapeSpec) -> G.GCNConfig:
    d_feat, n_classes = _GNN_SHAPE_DIMS[shape.name]
    return dataclasses.replace(arch.config, d_feat=d_feat,
                               n_classes=n_classes)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _gnn_state(cfg: G.GCNConfig):
    pshape = G.init_params(cfg, None, device="meta")
    oshape = init_opt_state_shape(pshape)
    return pshape, oshape, _replicated(pshape), _replicated(oshape)


def gnn_full_graph_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh
                        ) -> LoweringSpec:
    cfg = _gnn_cfg_for_shape(arch, shape)
    if shape.kind == "molecule":
        N = shape.params["n_nodes"] * shape.params["batch"]
        E = shape.params["n_edges"] * shape.params["batch"]
    else:
        N, E = shape.params["n_nodes"], shape.params["n_edges"]
    # node/edge counts padded to the data-parallel extent (padding edges
    # are self-loops with zero norm; padding nodes are masked out of the
    # loss — the real loaders pad identically)
    dp = _dp_total(mesh)
    N, E = _pad_to(N, dp), _pad_to(E, dp)
    pshape, oshape, pspecs, ospecs = _gnn_state(cfg)
    d0 = batch_spec(mesh, 1)[0]
    f32 = torch.float32
    args = (pshape, oshape,
            _meta((N, cfg.d_feat), f32),      # feats
            _meta((E,)),                      # src
            _meta((E,)),                      # dst
            _meta((E,), f32),                 # edge_norm
            _meta((N,)),                      # labels
            _meta((N,), f32))                 # mask

    def loss(p, batch):
        return G.loss_fn(p, cfg, *batch)

    return LoweringSpec(
        fn=_train_fn(loss, AdamWConfig()), args=args,
        in_shardings=(pspecs, ospecs, P(d0, None), P(d0), P(d0), P(d0),
                      P(d0), P(d0)),
        out_shardings=(pspecs, ospecs, dict(_METRICS)),
        donate_argnums=(0, 1), mesh=mesh, kind=shape.kind)


def gnn_minibatch_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh
                       ) -> LoweringSpec:
    cfg = _gnn_cfg_for_shape(arch, shape)
    Bn = shape.params["batch_nodes"]
    fanouts = list(shape.params["fanouts"])
    deepest = Bn * int(np.prod(fanouts))
    pshape, oshape, pspecs, ospecs = _gnn_state(cfg)
    d0 = batch_spec(mesh, 1)[0]
    args = (pshape, oshape, _meta((deepest, cfg.d_feat), torch.float32),
            _meta((Bn,)))                     # seed labels

    def loss(p, batch):
        deepest_feats, labels = batch
        logits = G.minibatch_forward(p, cfg, deepest_feats, fanouts)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
        return torch.mean(lse - gold)

    return LoweringSpec(
        fn=_train_fn(loss, AdamWConfig()), args=args,
        in_shardings=(pspecs, ospecs, P(d0, None), P(d0)),
        out_shardings=(pspecs, ospecs, dict(_METRICS)),
        donate_argnums=(0, 1), mesh=mesh, kind=shape.kind)


# =============================================================================
# RecSys family
# =============================================================================

def _recsys_param_shardings(arch: ArchSpec, mesh: Mesh, cfg=None):
    cfg = cfg or arch.config
    init = R.deepfm_init if arch.name == "deepfm" else R.seqrec_init
    pshape = init(cfg, None, device="meta")
    return pshape, spec_tree(pshape, recsys_param_spec, mesh)


def _recsys_batch_args(arch: ArchSpec, B: int, mesh: Mesh):
    """(args, specs) for one forward batch of size B."""
    cfg = arch.config
    bspec = batch_spec(mesh, 2, B)
    b1 = batch_spec(mesh, 1, B)
    if arch.name == "deepfm":
        return (_meta((B, cfg.n_fields)),), (bspec,)
    if arch.name == "bst":
        return (_meta((B, cfg.seq_len)), _meta((B,))), (bspec, b1)
    return (_meta((B, cfg.seq_len)),), (bspec,)


def recsys_train_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                      variant: str = "baseline") -> LoweringSpec:
    cfg = arch.config
    # p_bf16 was measured and refuted in the reference; "opt-pbf16" only
    if variant == "opt-pbf16" and hasattr(cfg, "p_bf16"):
        cfg = dataclasses.replace(cfg, p_bf16=True)
    B = shape.params["batch"]
    pshape, pspecs = _recsys_param_shardings(arch, mesh, cfg)
    oshape = init_opt_state_shape(pshape)
    ospecs = _zero1_tree(pshape, recsys_param_spec, mesh)
    bspec = batch_spec(mesh, 2, B)
    b1 = batch_spec(mesh, 1, B)
    f32 = torch.float32

    if arch.name == "deepfm":
        batch = (_meta((B, cfg.n_fields)), _meta((B,), f32))
        specs = (bspec, b1)

        def loss(p, b):
            return R.deepfm_loss(p, cfg, *b)
    elif arch.name == "bst":
        batch = (_meta((B, cfg.seq_len)), _meta((B,)), _meta((B,), f32))
        specs = (bspec, b1, b1)

        def loss(p, b):
            return R.bst_loss(p, cfg, *b)
    elif arch.name == "bert4rec":
        M = max(1, cfg.seq_len // 5)  # 20% masking
        batch = (_meta((B, cfg.seq_len)), _meta((B, M)), _meta((B, M)),
                 _meta((cfg.n_neg,)))
        specs = (bspec, bspec, bspec, P(None))

        def loss(p, b):
            return R.bert4rec_masked_loss(p, cfg, *b)
    else:  # sasrec
        batch = (_meta((B, cfg.seq_len)), _meta((B, cfg.seq_len)),
                 _meta((cfg.n_neg,)))
        specs = (bspec, bspec, P(None))

        def loss(p, b):
            return R.seqrec_sampled_loss(p, cfg, *b)

    return LoweringSpec(
        fn=_train_fn(loss, AdamWConfig()), args=(pshape, oshape) + batch,
        in_shardings=(pspecs, ospecs) + specs,
        out_shardings=(pspecs, ospecs, dict(_METRICS)),
        donate_argnums=(0, 1), mesh=mesh, kind=shape.kind)


def recsys_serve_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh
                      ) -> LoweringSpec:
    cfg = arch.config
    B = shape.params["batch"]
    pshape, pspecs = _recsys_param_shardings(arch, mesh)
    args, arg_specs = _recsys_batch_args(arch, B, mesh)
    ospec = batch_spec(mesh, 1, B)

    if arch.name == "deepfm":
        def serve_step(params, ids):
            return R.deepfm_forward(params, cfg, ids)
    elif arch.name == "bst":
        def serve_step(params, seq, tgt):
            return R.bst_forward(params, cfg, seq, tgt)
    else:
        ospec = batch_spec(mesh, 2, B)

        def serve_step(params, seq):
            h = R.seqrec_encode(params, cfg, seq)
            last = h[:, -1, :]
            return torch.sum(last * last, dim=-1, keepdim=True) * 0 + last

    return LoweringSpec(fn=serve_step, args=(pshape,) + args,
                        in_shardings=(pspecs,) + arg_specs,
                        out_shardings=ospec, mesh=mesh, kind=shape.kind)


def recsys_retrieval_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh
                          ) -> LoweringSpec:
    cfg = arch.config
    B = shape.params["batch"]
    C = shape.params["n_candidates"]
    pshape, pspecs = _recsys_param_shardings(arch, mesh)

    if arch.name == "deepfm":
        # one user context against C candidate items: a (C, n_fields)
        # forward
        def retrieval_step(params, ids):
            return R.deepfm_forward(params, cfg, ids)

        return LoweringSpec(
            fn=retrieval_step, args=(pshape, _meta((C, cfg.n_fields))),
            in_shardings=(pspecs, P("model", None)),
            out_shardings=P("model"), mesh=mesh, kind=shape.kind)

    def retrieval_step(params, seq, cand_ids):
        return R.seqrec_score_candidates(params, cfg, seq, cand_ids)

    return LoweringSpec(
        fn=retrieval_step,
        args=(pshape, _meta((B, cfg.seq_len)), _meta((C,))),
        in_shardings=(pspecs, P(None, None), P("model")),
        out_shardings=P(None, "model"), mesh=mesh, kind=shape.kind)


# =============================================================================
# repair-ir (the paper's own architecture)
# =============================================================================

_IR_FIELDS = ("sym_left", "sym_right", "sym_sum", "sym_len", "c", "starts",
              "firsts", "lengths", "lasts", "kbits", "bucket_offsets",
              "bck_c_pos", "bck_abs")


def _ir_index_shapes(cfg) -> dict:
    """Meta tensors of a production-scale FlatIndex."""
    S, N, L, BK = cfg.num_symbols, cfg.c_len, cfg.num_lists, cfg.num_buckets
    size = {"sym_left": S, "sym_right": S, "sym_sum": S, "sym_len": S,
            "c": N, "starts": L + 1, "firsts": L, "lengths": L, "lasts": L,
            "kbits": L, "bucket_offsets": L + 1, "bck_c_pos": BK,
            "bck_abs": BK}
    return {k: _meta((size[k],)) for k in _IR_FIELDS}


def _ir_index_shardings(mesh: Mesh) -> dict:
    """Every FlatIndex array replicated in the baseline; queries shard
    over the data axes."""
    return {k: P(None) for k in _IR_FIELDS}


def _shift_right_logical(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``lax.shift_right_logical`` on int32: the bits shifted as unsigned
    (torch's ``>>`` on int32 is arithmetic), 0 for shifts of 32 or more."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    out = (u >> torch.clamp(k, 0, 63).to(torch.int64)).to(torch.int32)
    return torch.where(k >= 32, torch.zeros_like(out), out)


def _ir_next_geq(idx: dict, static, list_id: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """next_geq over the index-dict form for lanes of any shape (the
    reference's ``_ir_next_geq`` under ``vmap``, unrolled): the bucket
    scan and the grammar descent run their fixed trip counts."""
    max_scan, max_depth, Tn = static
    c, starts = idx["c"], idx["starts"]
    last_c = c.shape[0] - 1
    start = starts[list_id]
    end = starts[list_id + 1]
    first = idx["firsts"][list_id]
    last = idx["lasts"][list_id]
    b = _shift_right_logical(x, idx["kbits"][list_id])
    boff = idx["bucket_offsets"][list_id]
    bnum = idx["bucket_offsets"][list_id + 1] - boff
    b = torch.minimum(b, torch.clamp(bnum - 1, min=0))
    j = idx["bck_c_pos"][boff + b]
    s = idx["bck_abs"][boff + b]
    j = torch.where(x <= first, 0, j)
    s = torch.where(x <= first, first, s)
    zero = torch.zeros_like(j)
    for _ in range(max_scan):
        in_range = start + j < end
        sym = torch.where(in_range, c[torch.clamp(start + j, max=last_c)],
                          zero)
        ps = torch.where(in_range, idx["sym_sum"][sym], zero)
        take = in_range & (s + ps < x)
        j = j + take.to(torch.int32)
        s = s + torch.where(take, ps, zero)
    done_early = s >= x
    past_end = start + j >= end
    sym, s_f = c[torch.clamp(start + j, max=last_c)], s
    for _ in range(max_depth):
        is_rule = sym >= Tn
        left = torch.where(is_rule, idx["sym_left"][sym], sym)
        right = torch.where(is_rule, idx["sym_right"][sym], sym)
        ls = idx["sym_sum"][left]
        go_left = s_f + ls >= x
        sym, s_f = (torch.where(is_rule, torch.where(go_left, left, right),
                                sym),
                    torch.where(is_rule & ~go_left, s_f + ls, s_f))
    out = torch.where(done_early, s, s_f + idx["sym_sum"][sym])
    inf = torch.full_like(out, INT_INF)
    out = torch.where(past_end & ~done_early, inf, out)
    return torch.where(x > last, inf, out).to(torch.int32)


def repair_ir_spec(arch: ArchSpec, shape: ShapeSpec, mesh: Mesh,
                   variant: str = "baseline") -> LoweringSpec:
    cfg = arch.config
    if variant == "opt":
        # denser (b)-sampling and the rule-optimized grammar shrink the
        # two fixed trip counts (the reference's space-for-time trade)
        cfg = dataclasses.replace(cfg, max_scan=8, max_depth=16)
    idx_shapes = _ir_index_shapes(cfg)
    idx_specs = _ir_index_shardings(mesh)
    static = (cfg.max_scan, cfg.max_depth,
              cfg.num_symbols // 2)   # half the ids are dense terminals
    bspec = batch_spec(mesh, 1)

    if shape.kind == "ir_members":
        B = shape.params["batch"]

        def member_step(idx, list_ids, xs):
            return _ir_next_geq(idx, static, list_ids, xs) == xs

        return LoweringSpec(fn=member_step,
                            args=(idx_shapes, _meta((B,)), _meta((B,))),
                            in_shardings=(idx_specs, bspec, bspec),
                            out_shardings=bspec, mesh=mesh, kind=shape.kind)

    if shape.kind == "ir_pairs":
        B = shape.params["batch"]
        M = cfg.max_short_len

        def pairs_step(idx, shorts, long_ids):
            vals = _ir_next_geq(idx, static,
                                long_ids[:, None].expand_as(shorts), shorts)
            hit = (vals == shorts) & (shorts != INT_INF)
            return torch.where(hit, shorts, torch.full_like(shorts, INT_INF))

        return LoweringSpec(
            fn=pairs_step,
            args=(idx_shapes, _meta((B, M)),    # expanded shorts
                  _meta((B,))),                 # long ids
            in_shardings=(idx_specs, batch_spec(mesh, 2), bspec),
            out_shardings=batch_spec(mesh, 2), mesh=mesh, kind=shape.kind)

    # ir_decode: bulk gap -> docid decode (prefix sums), rows of gaps
    rows, cols = shape.params["rows"], shape.params["cols"]
    rspec = batch_spec(mesh, 2)

    def decode_step(gaps, firsts):
        return torch.cumsum(gaps, dim=1, dtype=torch.int32) + firsts

    return LoweringSpec(fn=decode_step,
                        args=(_meta((rows, cols)), _meta((rows, 1))),
                        in_shardings=(rspec, rspec), out_shardings=rspec,
                        mesh=mesh, kind=shape.kind)


# =============================================================================
# dispatch
# =============================================================================

def build_lowering_spec(arch_name: str, shape_name: str, mesh: Mesh,
                        unroll: bool = False,
                        n_layers_override: int | None = None,
                        variant: str = "baseline",
                        shape: ShapeSpec | None = None) -> LoweringSpec:
    """The cell's spec on ``mesh``; ``shape`` (default: the arch's shape
    of that name) lets the dry run pass the same shape at another
    batch."""
    arch = get_arch(arch_name)
    shape = shape or arch.shape(shape_name)
    if arch.family == "lm":
        if shape.kind == "train":
            return lm_train_spec(arch, shape, mesh, unroll,
                                 n_layers_override, variant)
        if shape.kind == "prefill":
            return lm_prefill_spec(arch, shape, mesh, unroll,
                                   n_layers_override, variant)
        return lm_decode_spec(arch, shape, mesh, unroll, n_layers_override,
                              variant)
    if arch.family == "gnn":
        if shape.kind == "minibatch":
            return gnn_minibatch_spec(arch, shape, mesh)
        return gnn_full_graph_spec(arch, shape, mesh)
    if arch.family == "recsys":
        if shape.kind == "train":
            return recsys_train_spec(arch, shape, mesh, variant)
        if shape.kind == "retrieval":
            return recsys_retrieval_spec(arch, shape, mesh)
        return recsys_serve_spec(arch, shape, mesh)
    if arch.family == "repair_ir":
        return repair_ir_spec(arch, shape, mesh, variant)
    raise ValueError(f"unknown family {arch.family}")


def spec_leaves(tree) -> dict[str, P]:
    """``{path: P}`` of a tree of specs, with the paths of
    ``train.tree.leaves_with_paths``."""
    return dict(leaves_with_paths(tree, is_leaf=lambda x: isinstance(x, P)))


def all_cells(include_repair_ir: bool = True) -> list[tuple[str, str]]:
    """The 40 assigned cells (+ the paper's own arch if requested)."""
    cells = []
    for a in list_archs():
        arch = get_arch(a)
        if arch.family == "repair_ir" and not include_repair_ir:
            continue
        for s in arch.shapes:
            cells.append((a, s.name))
    return cells
