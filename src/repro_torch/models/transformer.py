"""Decoder-only LM covering the 5 assigned transformer architectures:

* qwen3-32b      — dense, GQA(64q/8kv, head 128), qk-norm
* yi-6b          — dense, GQA(32q/4kv, head 128), llama-arch
* minicpm3-4b    — dense, MLA (latent attention)
* granite-moe    — MoE 40e top-8, GQA(24q/8kv)
* phi3.5-moe     — MoE 16e top-2, GQA(32q/8kv)

:class:`Transformer` is an ``nn.Module``: the embedding, a ``ModuleList``
of blocks (one per layer, each holding that layer's slice of the
reference's stacked parameters), the final norm and the unembedding.
``forward``, ``prefill``, ``decode_step`` and ``lm_loss`` compute what the
reference's functions of those names compute, layer by layer in a Python
loop where the reference scans.  The KV cache keeps the reference's
stacked layout ``(L, B, S_cache, ...)``; ``decode_step`` writes it in
place.

``long_500k`` uses the sliding-window attention mode (window 4096) with a
ring KV cache of window size.

The model trains as the reference's does: with gradients on (the training
tier turns them on), ``forward`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint(...,
policy=nothing_saveable)`` on its scanned layer), and
:meth:`Transformer.stacked_leaves` names the parameters as the leaves of
the reference's stacked tree, which the optimizer and the checkpoints walk.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import Mesh
from ..kernels import resolve_device
from . import layers as L
from .layers import Dtype
from .moe import init_moe, moe_ffn


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    attn: str = "gqa"            # "gqa" | "mla"
    # MLA dims (minicpm3)
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    nope_dim: int = 64
    rope_dim: int = 32
    v_dim: int = 64
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1          # dispatch groups (set to the dp extent)
    # misc
    rope_theta: float = 1e6
    window: int | None = None    # sliding-window attention (long-context)
    vocab_pad_to: int = 512      # pad vocab so it shards evenly
    kv_chunk: int = 1024
    # mesh wiring (None in the single-device tests): with ``mesh`` (the
    # port's Mesh) and ``tp_axis`` set, the MoE dispatches through
    # ``moe_ffn_sharded``; ``sp_axis`` and ``attn_head_shard`` are the
    # reference's layout constraints, which change no value (the
    # parameters stay on the model's device), so here they compute nothing
    dp_spec: Any = None          # axis (or tuple) the batch shards over
    tp_axis: Any = None          # the tensor-parallel axis name
    mesh: Any = None             # the Mesh (enables the sharded MoE)
    sp_axis: Any = None          # sequence-parallel axis of activations
    unroll_layers: bool = False  # the reference's scan unroll (its dry-run
    #                              cost accounting); the port's layer loop
    #                              is a Python loop, unrolled either way
    # numerics flags of the reference's §Perf work
    bf16_combine: bool = False   # bf16 combine of row-parallel outputs;
    #                              on one device it changes only the
    #                              logits of ``forward`` (rounded to bf16)
    flash_p_bf16: bool = False   # bf16 attention probability tiles
    moe_ep_pad: bool = False     # pad experts to a tp multiple -> EP
    attn_head_shard: bool = False  # pin the flash kv chunks head-sharded

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"LMConfig.mesh must be a repro_torch Mesh, got "
                            f"{type(self.mesh).__name__}")

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m

    def param_count(self) -> int:
        """Total parameters (for 6ND MODEL_FLOPS accounting)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        if self.attn == "mla":
            qk = self.nope_dim + self.rope_dim
            attn = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
                    + d * (self.kv_lora_rank + self.rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.nope_dim + self.v_dim)
                    + self.n_heads * self.v_dim * d)
        else:
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv) \
                + self.n_heads * self.head_dim * d
        if self.moe:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * V * d + d

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k experts)."""
        if not self.moe:
            return self.param_count()
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv) \
            + self.n_heads * self.head_dim * d
        ffn = self.top_k * 3 * d * f + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * V * d + d


def init_cache_shape(cfg: LMConfig, batch: int, s_cache: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each stacked per-layer KV cache buffer.
    GQA: (L, B, S, KH, D) k and v; MLA: (L, B, S, r) latent + (L, B, S, rd)."""
    if cfg.attn == "mla":
        return {
            "ckv": ((cfg.n_layers, batch, s_cache, cfg.kv_lora_rank), Dtype),
            "krope": ((cfg.n_layers, batch, s_cache, cfg.rope_dim), Dtype),
        }
    kv = (cfg.n_layers, batch, s_cache, cfg.n_kv, cfg.head_dim)
    return {"k": (kv, Dtype), "v": (kv, Dtype)}


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One decoder layer: pre-norm attention (GQA or MLA) and pre-norm FFN
    (SwiGLU or MoE), each added to the residual stream."""

    def __init__(self, cfg: LMConfig, attn: dict, ffn: dict,
                 ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.attn = _params(attn)
        self.ffn = _params(ffn)
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)

    def _attention(self, h, positions, p_bf16: bool):
        # the reference's ``attn_shard`` (cfg.attn_head_shard) pins the
        # chunk-stacked kv operands with a sharding constraint: a layout,
        # not a value, so it computes nothing here
        cfg = self.cfg
        if cfg.attn == "mla":
            return L.mla_attention(
                self.attn, h, positions, n_heads=cfg.n_heads,
                nope_dim=cfg.nope_dim, rope_dim=cfg.rope_dim,
                v_dim=cfg.v_dim, kv_lora_rank=cfg.kv_lora_rank,
                rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk,
                window=cfg.window, p_bf16=p_bf16)
        return L.gqa_attention(
            self.attn, h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=cfg.window, kv_chunk=cfg.kv_chunk, p_bf16=p_bf16)

    def _ffn(self, x):
        """The FFN half of the layer on the residual stream x (B, S, d):
        (x + ffn(norm(x)), aux)."""
        cfg = self.cfg
        h = L.rms_norm(x, self.ln2)
        if cfg.moe:
            B, S, d = h.shape
            out, aux = moe_ffn(self.ffn, h.reshape(B * S, d),
                               n_experts=cfg.n_experts, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               num_groups=cfg.moe_groups,
                               dp_spec=cfg.dp_spec, tp_axis=cfg.tp_axis,
                               mesh=cfg.mesh, ep_pad=cfg.moe_ep_pad)
            return x + out.reshape(B, S, d), aux
        return x + L.swiglu(h, **self.ffn), \
            torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, x, positions):
        h = L.rms_norm(x, self.ln1)
        return self._ffn(x + self._attention(h, positions,
                                             self.cfg.flash_p_bf16))

    def prefill(self, x, positions):
        """As ``forward``, and this layer's cache entries for the prompt:
        (k, v) after norm and RoPE, or MLA's (c_kv, k_rope)."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = L.rms_norm(x, self.ln1)
        p = self.attn
        if cfg.attn == "mla":
            kv_a = L.dense(h, p["wkv_a"])
            c_kv, k_rope = kv_a.split([cfg.kv_lora_rank, cfg.rope_dim],
                                      dim=-1)
            c_kv = L.rms_norm(c_kv, p["kv_a_norm"])
            cos, sin = L.rope_angles(positions, cfg.rope_dim, cfg.rope_theta)
            k_rope = L.apply_rope(k_rope.reshape(B, S, 1, cfg.rope_dim),
                                  cos, sin).reshape(B, S, cfg.rope_dim)
            kv_out = (c_kv, k_rope)
        else:
            # recompute k / v for the cache, as the reference does
            k = L.dense(h, p["wk"]).reshape(B, S, cfg.n_kv, cfg.head_dim)
            v = L.dense(h, p["wv"]).reshape(B, S, cfg.n_kv, cfg.head_dim)
            if "k_norm" in p:
                k = L.rms_norm(k, p["k_norm"])
            cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            kv_out = (L.apply_rope(k, cos, sin), v)
        # the reference's prefill leaves flash_p_bf16 unset
        a = self._attention(h, positions, False)
        x, _ = self._ffn(x + a)
        return x, kv_out

    def decode(self, x, c1, c2, position, kv_len):
        """One token per lane: x (B, 1, d); writes the caches in place."""
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1)
        if cfg.attn == "mla":
            a, _, _ = L.mla_decode(
                self.attn, h, c1, c2, position, n_heads=cfg.n_heads,
                nope_dim=cfg.nope_dim, rope_dim=cfg.rope_dim,
                v_dim=cfg.v_dim, kv_lora_rank=cfg.kv_lora_rank,
                rope_theta=cfg.rope_theta, kv_len=kv_len)
        else:
            a, _, _ = L.gqa_decode(
                self.attn, h, c1, c2, position, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, kv_len=kv_len)
        x, _ = self._ffn(x + a)
        return x


class Transformer(nn.Module):
    """The LM: ``embed`` (V, d), ``blocks``, ``ln_f`` and ``unembed`` (d, V),
    V = ``cfg.padded_vocab`` (the padded columns are live random columns,
    as in the reference).  Parameters are bf16 (the MoE router float32)
    and are made without ``requires_grad``, as serving wants them; the
    training tier turns it on, and ``forward`` then recomputes each layer
    in the backward.

    ``Transformer(cfg, device=...)`` allocates the parameters, uninitialized,
    on ``device`` — ``"cuda"`` by default, which raises without a card;
    ``"meta"`` gives their shapes only (:func:`init_params_shape`);
    :func:`init_params` fills them from a seeded generator and
    ``models.convert.lm_params_from_numpy`` from the reference's tree."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        dev = torch.device("meta") if torch.device(device).type == "meta" \
            else resolve_device(device)
        self.cfg = cfg
        V, d = cfg.padded_vocab, cfg.d_model

        def empty(shape, dtype=Dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        def layer():
            if cfg.attn == "mla":
                qk = cfg.nope_dim + cfg.rope_dim
                attn = {"wq_a": empty((d, cfg.q_lora_rank)),
                        "q_a_norm": empty((cfg.q_lora_rank,)),
                        "wq_b": empty((cfg.q_lora_rank, cfg.n_heads * qk)),
                        "wkv_a": empty((d, cfg.kv_lora_rank + cfg.rope_dim)),
                        "kv_a_norm": empty((cfg.kv_lora_rank,)),
                        "wkv_b": empty((cfg.kv_lora_rank, cfg.n_heads
                                        * (cfg.nope_dim + cfg.v_dim))),
                        "wo": empty((cfg.n_heads * cfg.v_dim, d))}
            else:
                hd = cfg.head_dim
                attn = {"wq": empty((d, cfg.n_heads * hd)),
                        "wk": empty((d, cfg.n_kv * hd)),
                        "wv": empty((d, cfg.n_kv * hd)),
                        "wo": empty((cfg.n_heads * hd, d))}
                if cfg.qk_norm:
                    attn["q_norm"] = empty((hd,))
                    attn["k_norm"] = empty((hd,))
            if cfg.moe:
                E, f = cfg.n_experts, cfg.d_ff
                ffn = {"router": empty((d, E), torch.float32),
                       "w_gate": empty((E, d, f)), "w_up": empty((E, d, f)),
                       "w_down": empty((E, f, d))}
            else:
                ffn = {"w_gate": empty((d, cfg.d_ff)),
                       "w_up": empty((d, cfg.d_ff)),
                       "w_down": empty((cfg.d_ff, d))}
            return Block(cfg, attn, ffn, empty((d,)), empty((d,)))

        self.embed = nn.Parameter(empty((V, d)), requires_grad=False)
        self.blocks = nn.ModuleList(layer() for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(empty((d,)), requires_grad=False)
        self.unembed = nn.Parameter(empty((d, V)), requires_grad=False)

    def stacked_leaves(self) -> list[tuple[str, Any]]:
        """The reference's parameter tree, leaf by leaf in its order
        (sorted keys): ``(path, tensor)`` for ``embed``, ``ln_f`` and
        ``unembed``, ``(path, [L block tensors])`` for each ``layers/...``
        leaf, which the reference holds stacked ``(L, ...)``."""
        blocks = list(self.blocks)
        out: list[tuple[str, Any]] = [("embed", self.embed)]
        for group in ("attn", "ffn"):
            for k in sorted(getattr(blocks[0], group)):
                out.append((f"layers/{group}/{k}",
                            [getattr(b, group)[k] for b in blocks]))
        out += [("layers/ln1", [b.ln1 for b in blocks]),
                ("layers/ln2", [b.ln2 for b in blocks]),
                ("ln_f", self.ln_f), ("unembed", self.unembed)]
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.matmul_f32(L.rms_norm(x, self.ln_f), self.unembed)

    def forward(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) int -> (logits (B, S, V) float32, aux_loss)."""
        tokens = tokens.to(self.device)
        S = tokens.shape[1]
        x = self.embed[tokens.long()]                   # gather (B, S, d)
        positions = torch.arange(S, device=self.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        # the reference constrains the carry between layers to (dp, sp,
        # None) when cfg.sp_axis is set (``_sp_constrain``): a layout, not
        # a value, so nothing here
        for blk in self.blocks:
            if torch.is_grad_enabled() and blk.ln1.requires_grad:
                x, a = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x, a = blk(x, positions)
            aux = aux + a
        if self.cfg.bf16_combine:
            h = L.rms_norm(x, self.ln_f)
            return L.dense(h, self.unembed).float(), aux
        return self._logits(x), aux

    def lm_loss(self, tokens: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
        logits, aux = self.forward(tokens)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets.to(self.device).long()[..., None])[..., 0]
        return torch.mean(lse - gold) + 0.01 * aux

    def init_cache(self, batch: int, s_cache: int) -> dict:
        """Zeroed KV cache buffers on the model's device."""
        return {k: torch.zeros(shape, dtype=dtype, device=self.device)
                for k, (shape, dtype) in
                init_cache_shape(self.cfg, batch, s_cache).items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Run the prompt through the model: returns the last position's
        logits (B, V) float32 and the populated KV cache, stacked per layer
        ((L, B, S, ...), as :func:`init_cache_shape` names them)."""
        tokens = tokens.to(self.device)
        S = tokens.shape[1]
        x = self.embed[tokens.long()]
        positions = torch.arange(S, device=self.device)[None, :]
        kvs = []
        for blk in self.blocks:
            x, kv = blk.prefill(x, positions)
            kvs.append(kv)
        names = ("ckv", "krope") if self.cfg.attn == "mla" else ("k", "v")
        cache = {n: torch.stack([kv[i] for kv in kvs])
                 for i, n in enumerate(names)}
        return self._logits(x[:, -1, :]), cache

    @torch.no_grad()
    def decode_step(self, token, cache: dict, position
                    ) -> tuple[torch.Tensor, dict]:
        """One serving step: token (B,) int, position (B,) int (absolute
        index of the new token), cache of stacked per-layer buffers,
        written in place.  Returns (logits (B, V) float32, cache).

        Given ``position`` on the host (a numpy array or a CPU tensor), the
        attention reads each layer's cache only up to the last valid slot
        of any lane; the slots after it are masked and add exact zeros, so
        the values are those of reading all ``S_cache`` slots."""
        position = torch.as_tensor(position)
        names = ("ckv", "krope") if self.cfg.attn == "mla" else ("k", "v")
        s_cache = cache[names[0]].shape[2]
        kv_len = None
        if position.device.type == "cpu" and position.numel():
            kv_len = min(int(position.max()) + 1, s_cache)
        position = position.to(self.device)
        token = torch.as_tensor(token).to(self.device)
        x = self.embed[token.long()][:, None, :]         # (B, 1, d)
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cache[names[0]][i], cache[names[1]][i],
                           position, kv_len)
        return self._logits(x[:, 0, :]), cache


def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` with the reference's init law:
    N(0, 1/d) embedding and unembedding, N(0, 1/fan_in) projections, unit
    norms, drawn from ``generator`` (which must live on ``device``; the
    same seed on the same device gives the same parameters)."""
    model = Transformer(cfg, device)
    dev = model.device
    s = cfg.d_model ** -0.5
    V, d = cfg.padded_vocab, cfg.d_model
    with torch.no_grad():
        model.embed.copy_(L.randn_scaled(generator, (V, d), s, Dtype, dev))
        for blk in model.blocks:
            if cfg.attn == "mla":
                attn = L.init_mla(generator, d, cfg.n_heads,
                                  q_lora_rank=cfg.q_lora_rank,
                                  kv_lora_rank=cfg.kv_lora_rank,
                                  nope_dim=cfg.nope_dim,
                                  rope_dim=cfg.rope_dim, v_dim=cfg.v_dim,
                                  device=dev)
            else:
                attn = L.init_gqa(generator, d, cfg.n_heads, cfg.n_kv,
                                  cfg.head_dim, cfg.qk_norm, device=dev)
            if cfg.moe:
                ffn = init_moe(generator, d, cfg.d_ff, cfg.n_experts,
                               device=dev)
            else:
                ffn = L.init_swiglu(generator, d, cfg.d_ff, device=dev)
            for k, v in attn.items():
                blk.attn[k].copy_(v)
            for k, v in ffn.items():
                blk.ffn[k].copy_(v)
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
        model.ln_f.fill_(1.0)
        model.unembed.copy_(L.randn_scaled(generator, (d, V), s, Dtype, dev))
    return model


def init_params_shape(cfg: LMConfig) -> Transformer:
    """The parameters' shapes and dtypes, nothing allocated: a
    :class:`Transformer` on the meta device (the reference's
    ``ShapeDtypeStruct`` tree, for the dry run and the partition rules)."""
    return Transformer(cfg, "meta")
