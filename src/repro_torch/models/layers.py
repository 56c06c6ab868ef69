"""Shared transformer layers: RMSNorm, RoPE, GQA attention (with optional
per-head qk-norm and KV-head repetition), MLA (DeepSeek-V2-style latent
attention, used by MiniCPM3), SwiGLU MLP, and a chunked ("flash-style")
attention that never materializes the full S×S score matrix — the 32k
prefill shapes need it to fit device memory.

All functions are pure; parameters are plain dicts of tensors (an
``nn.ParameterDict`` serves as one).  Compute dtype is bf16, accumulation
fp32, as in the reference: on the CPU a product is taken in float32 and
rounded once; on the card cuBLAS takes bf16 operands, accumulates in
float32 and rounds its output once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Dtype = torch.bfloat16
NEG_INF = -1e30


# -- basics ------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 1e6
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., dim//2) fp32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, D//2) — rotate the two
    halves of the head dimension (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """bf16 (M, K) @ (K, N) -> float32 on the card, with a gradient:
    ``torch.mm(..., out_dtype=float32)`` has none.  The backward keeps the
    float32 cotangent, as JAX's transpose of ``preferred_element_type=
    float32`` does, and returns bf16 gradients: each is the float32
    product of the cotangent and the other operand, rounded once (what the
    CPU path's autograd computes through its upcasts)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.float().t(), g).to(w.dtype)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), accumulated and returned in float32 (the
    reference's ``preferred_element_type=float32``).  On the card cuBLAS
    reads the bf16 operands as they are and writes float32; the meta
    device (the dry run's trace) takes the card's ops."""
    if (x.is_cuda or x.is_meta) and x.dtype == w.dtype == torch.bfloat16:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation, rounded once to ``x.dtype``.  (The
    reference's ``bf16_combine`` argument makes its row-parallel
    projections emit bf16 straight from the accumulator, so that tensor-
    parallel partial sums all-reduce in bf16; on one device both forms
    round the same f32 sum once, so the port has no such argument.)  The
    meta device takes the card's op."""
    if x.is_cuda or x.is_meta:
        return torch.matmul(x, w)        # bf16 in, f32 accumulate, bf16 out
    return (x.float() @ w.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(h, w_down)


# -- chunked causal attention (flash-style, plain torch ops) -----------------

def _chunk_attn(q, k, v, q_offset: int, kv_offset: int, window: int | None,
                p_bf16: bool = False):
    """One (q_chunk, kv_chunk) tile: returns (out_unnorm, row_max,
    row_sumexp).  q (B, Tq, H, D), k/v (B, Tk, H, D).  ``p_bf16`` rounds
    the probability tile to bf16 after its row sum (the reference's
    memory-traffic lever); the stats stay f32."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    dev = q.device
    qpos = q_offset + torch.arange(q.shape[1], device=dev)[:, None]
    kpos = kv_offset + torch.arange(k.shape[1], device=dev)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[None, None, :, :], NEG_INF)
    m = logits.amax(dim=-1)                             # (B,H,Tq)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    if p_bf16:
        p = p.to(torch.bfloat16)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out, m, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_chunk: int = 1024, window: int | None = None,
                    p_bf16: bool = False) -> torch.Tensor:
    """Causal attention without the full S×S intermediate.  q (B,S,H,D);
    k/v (B,S,KH,D) with KH == H (callers repeat KV heads first).  Walks
    the KV chunks in order keeping running (max, sumexp, out) — the
    online-softmax recurrence of FlashAttention, chunk by chunk as the
    reference's scan does."""
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    kv_chunk = min(kv_chunk, S_kv)
    S_pad = -(-S_kv // kv_chunk) * kv_chunk
    if S_pad != S_kv:
        # padded keys sit at positions > every query -> causally masked out
        k = F.pad(k, (0, 0, 0, 0, 0, S_pad - S_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, S_pad - S_kv))
    out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    for idx in range(S_pad // kv_chunk):
        sl = slice(idx * kv_chunk, (idx + 1) * kv_chunk)
        o_i, m_i, l_i = _chunk_attn(q, k[:, sl], v[:, sl], 0,
                                    idx * kv_chunk, window, p_bf16)
        m_new = torch.maximum(m, m_i)
        a = torch.exp(m - m_new)
        b = torch.exp(m_i - m_new)
        out = out * a[..., None].transpose(1, 2) + \
            o_i * b[..., None].transpose(1, 2)
        l = l * a + l_i * b
        m = m_new
    denom = torch.clamp(l, min=1e-30)[..., None].transpose(1, 2)
    return (out / denom).to(q.dtype)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, KH*n_rep, D) by head repetition (GQA share):
    head ``g * n_rep + r`` reads KV head ``g``."""
    if n_rep == 1:
        return k
    B, S, KH, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KH, n_rep, D).reshape(
        B, S, KH * n_rep, D)


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   position: torch.Tensor, s_cache: int) -> torch.Tensor:
    """One query per lane against its cache.  q (B, H, D); k (B, T, KH, D)
    and v (B, T, KH, Dv), the first T of the lane's ``s_cache`` slots, with
    H = KH * n_rep; position (B,).  Slot t of lane b is read when ``t <=
    min(position[b], s_cache - 1)``.  The query heads are grouped over
    their KV head (head ``g * n_rep + r``, as :func:`repeat_kv` lays them
    out), which gives the repeated form's values without materializing
    it.  Returns (B, H, Dv) float32."""
    B, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KH, H // KH, D)
    logits = torch.einsum("bgrd,btgd->bgrt", qg, k.float())
    logits = logits * (1.0 / math.sqrt(D))
    kpos = torch.arange(T, device=q.device)[None, :]
    valid = kpos <= torch.clamp(position, max=s_cache - 1)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", w.to(v.dtype).float(), v.float())
    return o.reshape(B, H, v.shape[-1])


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                position: torch.Tensor) -> None:
    """Write each lane's new entry (B, ...) at slot ``position % S_cache``
    of its cache (B, S_cache, ...), in place: the ring of the sliding
    window wraps there.  The reference blends a one-hot row into the whole
    cache, which gives the same values."""
    slot = torch.remainder(position.long(), cache.shape[1])
    cache[torch.arange(cache.shape[0], device=cache.device), slot] = new


# -- GQA attention block -------------------------------------------------------

def randn_scaled(generator: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale²) samples drawn in float32 from ``generator`` (which
    lives on ``device``), rounded once to ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_gqa(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, qk_norm: bool, dtype=Dtype,
             device="cpu") -> dict:
    s = 1.0 / math.sqrt(d_model)
    p = {
        "wq": randn_scaled(generator, (d_model, n_heads * head_dim), s, dtype,
                      device),
        "wk": randn_scaled(generator, (d_model, n_kv * head_dim), s, dtype,
                      device),
        "wv": randn_scaled(generator, (d_model, n_kv * head_dim), s, dtype,
                      device),
        "wo": randn_scaled(generator, (n_heads * head_dim, d_model), s, dtype,
                      device),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
    return p


def gqa_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, n_kv: int, head_dim: int,
                  rope_theta: float = 1e6, window: int | None = None,
                  kv_chunk: int = 1024, p_bf16: bool = False) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); full training/prefill attention."""
    B, S, _ = x.shape
    q = dense(x, p["wq"]).reshape(B, S, n_heads, head_dim)
    k = dense(x, p["wk"]).reshape(B, S, n_kv, head_dim)
    v = dense(x, p["wv"]).reshape(B, S, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k = repeat_kv(k, n_heads // n_kv)
    v = repeat_kv(v, n_heads // n_kv)
    o = flash_attention(q, k, v, kv_chunk=min(kv_chunk, S), window=window,
                        p_bf16=p_bf16)
    return dense(o.reshape(B, S, n_heads * head_dim), p["wo"])


def gqa_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, position: torch.Tensor, *,
               n_heads: int, n_kv: int, head_dim: int,
               rope_theta: float = 1e6, kv_len: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode.  x (B, 1, D); cache_k/v (B, S_cache, KH, D);
    position (B,) int — the new token's absolute index.  Writes the token
    at ``position % S_cache`` of the caches IN PLACE (the ring of the
    sliding window) and returns (out (B,1,D), cache_k, cache_v).
    ``kv_len`` bounds the slots read (default all): any bound past every
    lane's last valid slot gives the same values, since the slots after it
    are masked and add exact zeros."""
    B = x.shape[0]
    S_cache = cache_k.shape[1]
    q = dense(x, p["wq"]).reshape(B, 1, n_heads, head_dim)
    k = dense(x, p["wk"]).reshape(B, 1, n_kv, head_dim)
    v = dense(x, p["wv"]).reshape(B, 1, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(position[:, None], head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_slot(cache_k, k[:, 0], position)
    _write_slot(cache_v, v[:, 0], position)
    T = S_cache if kv_len is None else kv_len
    o = _decode_attend(q[:, 0], cache_k[:, :T], cache_v[:, :T], position,
                       S_cache).to(x.dtype)
    out = dense(o.reshape(B, 1, n_heads * head_dim), p["wo"])
    return out, cache_k, cache_v


# -- MLA (multi-head latent attention, DeepSeek-V2 / MiniCPM3) ----------------

def init_mla(generator: torch.Generator, d_model: int, n_heads: int, *,
             q_lora_rank: int, kv_lora_rank: int, nope_dim: int,
             rope_dim: int, v_dim: int, dtype=Dtype, device="cpu") -> dict:
    s = 1.0 / math.sqrt(d_model)
    qk_dim = nope_dim + rope_dim

    def normal(shape):
        return randn_scaled(generator, shape, s, dtype, device)

    return {
        "wq_a": normal((d_model, q_lora_rank)),
        "q_a_norm": torch.ones((q_lora_rank,), dtype=dtype, device=device),
        "wq_b": normal((q_lora_rank, n_heads * qk_dim)),
        "wkv_a": normal((d_model, kv_lora_rank + rope_dim)),
        "kv_a_norm": torch.ones((kv_lora_rank,), dtype=dtype, device=device),
        "wkv_b": normal((kv_lora_rank, n_heads * (nope_dim + v_dim))),
        "wo": normal((n_heads * v_dim, d_model)),
    }


def mla_attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  n_heads: int, nope_dim: int, rope_dim: int, v_dim: int,
                  kv_lora_rank: int, rope_theta: float = 1e4,
                  kv_chunk: int = 1024, window: int | None = None,
                  p_bf16: bool = False) -> torch.Tensor:
    """Latent attention, materialized form: latent c_kv (B,S,r) + shared
    k_rope; per-head k_nope/v decompressed from the latent.  The KV cache
    for decode stores only (c_kv, k_rope)."""
    B, S, _ = x.shape
    qk_dim = nope_dim + rope_dim
    q = dense(rms_norm(dense(x, p["wq_a"]), p["q_a_norm"]), p["wq_b"])
    q = q.reshape(B, S, n_heads, qk_dim)
    q_nope, q_rope = q.split([nope_dim, rope_dim], dim=-1)
    kv_a = dense(x, p["wkv_a"])
    c_kv, k_rope = kv_a.split([kv_lora_rank, rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_a_norm"])
    kv = dense(c_kv, p["wkv_b"]).reshape(B, S, n_heads, nope_dim + v_dim)
    k_nope, v = kv.split([nope_dim, v_dim], dim=-1)
    cos, sin = rope_angles(positions, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope.reshape(B, S, 1, rope_dim), cos, sin)
    k_rope = k_rope.expand(B, S, n_heads, rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    # pad v to qk_dim so flash_attention can share one head_dim, then slice
    v_pad = F.pad(v, (0, qk_dim - v_dim))
    o = flash_attention(q_full, k_full, v_pad, kv_chunk=min(kv_chunk, S),
                        window=window, p_bf16=p_bf16)[..., :v_dim]
    return dense(o.reshape(B, S, n_heads * v_dim), p["wo"])


def mla_decode(p: dict, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, position: torch.Tensor, *,
               n_heads: int, nope_dim: int, rope_dim: int, v_dim: int,
               kv_lora_rank: int, rope_theta: float = 1e4,
               kv_len: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode with latent cache: cache_ckv (B, S, r), cache_krope (B, S,
    rd), written in place at ``position % S`` (as :func:`gqa_decode`).
    Decompresses k_nope/v of the slots read for scoring (the dense path,
    as the reference)."""
    B = x.shape[0]
    S_cache = cache_ckv.shape[1]
    qk_dim = nope_dim + rope_dim
    q = dense(rms_norm(dense(x, p["wq_a"]), p["q_a_norm"]), p["wq_b"])
    q = q.reshape(B, 1, n_heads, qk_dim)
    q_nope, q_rope = q.split([nope_dim, rope_dim], dim=-1)
    kv_a = dense(x, p["wkv_a"])
    c_kv, k_rope = kv_a.split([kv_lora_rank, rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_a_norm"])
    cos, sin = rope_angles(position[:, None], rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope.reshape(B, 1, 1, rope_dim), cos, sin)
    _write_slot(cache_ckv, c_kv[:, 0], position)
    _write_slot(cache_krope, k_rope.reshape(B, rope_dim), position)

    T = S_cache if kv_len is None else kv_len
    kv = dense(cache_ckv[:, :T], p["wkv_b"]).reshape(B, T, n_heads,
                                                     nope_dim + v_dim)
    k_nope, v = kv.split([nope_dim, v_dim], dim=-1)
    k_rope_all = cache_krope[:, :T, None, :].expand(B, T, n_heads, rope_dim)
    k_full = torch.cat([k_nope, k_rope_all], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    o = _decode_attend(q_full[:, 0], k_full, v, position,
                       S_cache).to(x.dtype)
    out = dense(o.reshape(B, 1, n_heads * v_dim), p["wo"])
    return out, cache_ckv, cache_krope


# -- MLP ----------------------------------------------------------------------

def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=Dtype, device="cpu") -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {
        "w_gate": randn_scaled(generator, (d_model, d_ff), s, dtype, device),
        "w_up": randn_scaled(generator, (d_model, d_ff), s, dtype, device),
        "w_down": randn_scaled(generator, (d_ff, d_model), 1.0 / math.sqrt(d_ff),
                          dtype, device),
    }
