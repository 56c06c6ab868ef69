"""RecSys architectures: DeepFM, SASRec, BERT4Rec, BST.

``embedding_bag`` is a gather plus a scatter-add (``index_add_``) over bag
ids, the reference's ``jnp.take`` + ``segment_sum``.  Embedding tables are
the dominant state.  Parameters are trees of float32 tensors, as in the
reference.

Four serving regimes map to the assigned shapes:
* train_batch (65,536)  — full train step,
* serve_p99 (512)       — small-batch scoring,
* serve_bulk (262,144)  — offline scoring,
* retrieval_cand        — one context against 1M candidates: a single
                          (d,) @ (1M, d)^T matmul (batched dot, NOT a loop).

Sequence models train with sampled-softmax (vocabs reach 10^6), as the
papers' own negative-sampling losses do.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def _randn(generator, shape, scale, device):
    return torch.randn(shape, generator=generator, device=device) * scale


# -- embedding bag (the recsys hot path) --------------------------------------

def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` semantics: ``indices`` (N,) flat ids grouped
    into bags by ``offsets`` (B+1,); returns (B, d) reduced per bag."""
    emb = table[indices.long()]                              # (N, d)
    bag_ids = torch.searchsorted(
        offsets[1:].contiguous(),
        torch.arange(indices.shape[0], dtype=offsets.dtype,
                     device=offsets.device), right=True)
    out = torch.zeros((offsets.shape[0] - 1, table.shape[-1]),
                      dtype=emb.dtype, device=emb.device)
    out.index_add_(0, bag_ids, emb)
    if mode == "mean":
        counts = offsets[1:] - offsets[:-1]
        out = out / torch.clamp(counts, min=1)[:, None]
    return out


def embedding_bag_fixed(table: torch.Tensor, indices: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """Fixed-bag-size variant: indices (B, n) -> (B, d).  The common case
    for fielded models (one id per field)."""
    emb = table[indices.reshape(-1).long()]
    emb = emb.reshape(*indices.shape, table.shape[-1])
    return emb.sum(dim=-2) if mode == "sum" else emb.mean(dim=-2)


# ==============================================================================
# DeepFM  [arXiv:1703.04247]
# ==============================================================================

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    embed_dim: int = 10
    mlp_dims: tuple = (400, 400, 400)
    field_vocabs: tuple = ()        # per-field vocab sizes

    def total_rows(self) -> int:
        return sum(self.field_vocabs)


def deepfm_init(cfg: DeepFMConfig, generator: torch.Generator,
                device="cpu") -> dict:
    V = cfg.total_rows()
    d = cfg.embed_dim
    dims = [cfg.n_fields * d] + list(cfg.mlp_dims) + [1]
    return {
        # one concatenated table; fields offset into it
        "table": _randn(generator, (V, d), 0.01, device),
        "table_1d": _randn(generator, (V, 1), 0.01, device),
        "mlp_w": [_randn(generator, (dims[i], dims[i + 1]),
                         1.0 / math.sqrt(dims[i]), device)
                  for i in range(len(dims) - 1)],
        "mlp_b": [torch.zeros((dims[i + 1],), device=device)
                  for i in range(len(dims) - 1)],
        "bias": torch.zeros((), device=device),
    }


def deepfm_forward(p: dict, cfg: DeepFMConfig,
                   ids: torch.Tensor) -> torch.Tensor:
    """ids (B, n_fields) — already offset into the concatenated table.
    Returns logits (B,)."""
    B = ids.shape[0]
    d = cfg.embed_dim
    flat = ids.reshape(-1).long()
    emb = p["table"][flat].reshape(B, cfg.n_fields, d)
    lin = p["table_1d"][flat].reshape(B, cfg.n_fields).sum(-1)
    # FM 2nd order: 0.5 * ((sum v)^2 - sum v^2)
    sv = emb.sum(dim=1)
    fm = 0.5 * (sv.square() - emb.square().sum(dim=1)).sum(dim=-1)
    # deep part
    h = emb.reshape(B, cfg.n_fields * d)
    for i, (w, b) in enumerate(zip(p["mlp_w"], p["mlp_b"])):
        h = h @ w + b
        if i < len(p["mlp_w"]) - 1:
            h = torch.relu(h)
    return p["bias"] + lin + fm + h[:, 0]


def _bce_with_logits(logits, labels):
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def deepfm_loss(p, cfg, ids, labels):
    return _bce_with_logits(deepfm_forward(p, cfg, ids), labels)


# ==============================================================================
# Sequential models: SASRec [1808.09781], BERT4Rec [1904.06690], BST [1905.06874]
# ==============================================================================

@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    name: str
    n_items: int
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    causal: bool                    # sasrec/bst causal, bert4rec bidir
    mlp_dims: tuple = ()            # bst's final MLP
    n_neg: int = 128                # sampled-softmax negatives
    dropout: float = 0.0
    p_bf16: bool = False            # bf16 attention score/prob tiles;
    #                                 the stats math stays f32


def seqrec_init(cfg: SeqRecConfig, generator: torch.Generator,
                device="cpu") -> dict:
    d = cfg.embed_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "item_emb": _randn(generator, (cfg.n_items, d), 0.02, device),
        "pos_emb": _randn(generator, (cfg.seq_len, d), 0.02, device),
        "blocks": [{
            "wqkv": _randn(generator, (d, 3 * d), s, device),
            "wo": _randn(generator, (d, d), s, device),
            "w1": _randn(generator, (d, 4 * d), s, device),
            "w2": _randn(generator, (4 * d, d), 0.5 * s, device),
            "ln1": torch.ones((d,), device=device),
            "ln2": torch.ones((d,), device=device),
        } for _ in range(cfg.n_blocks)],
        "ln_f": torch.ones((d,), device=device),
    }
    if cfg.mlp_dims:
        dims = [2 * d] + list(cfg.mlp_dims) + [1]
        p["mlp_w"] = [_randn(generator, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), device)
                      for i in range(len(dims) - 1)]
        p["mlp_b"] = [torch.zeros((dims[i + 1],), device=device)
                      for i in range(len(dims) - 1)]
    return p


def _ln(x, g):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g


def _block(b: dict, x: torch.Tensor, n_heads: int, causal: bool,
           p_bf16: bool = False) -> torch.Tensor:
    B, S, d = x.shape
    hd = d // n_heads
    h = _ln(x, b["ln1"])
    qkv = (h @ b["wqkv"]).reshape(B, S, 3, n_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if p_bf16:
        q, k = q.bfloat16().float(), k.bfloat16().float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask[None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    if p_bf16:
        w = w.bfloat16().float()
        v = v.bfloat16().float()
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, d)
    x = x + o @ b["wo"]
    h = _ln(x, b["ln2"])
    h = F.gelu(h @ b["w1"], approximate="tanh")     # jax.nn.gelu's default
    return x + h @ b["w2"]


def seqrec_encode(p: dict, cfg: SeqRecConfig,
                  item_ids: torch.Tensor) -> torch.Tensor:
    """item_ids (B, S) -> contextual item states (B, S, d)."""
    x = p["item_emb"][item_ids.long()] + p["pos_emb"][None]
    for b in p["blocks"]:
        x = _block(b, x, cfg.n_heads, cfg.causal, cfg.p_bf16)
    return _ln(x, p["ln_f"])


def _sampled_softmax(h, pos_e, neg_e):
    pos_l = torch.sum(h * pos_e, dim=-1, keepdim=True)
    neg_l = torch.einsum("bsd,nd->bsn", h, neg_e)
    logits = torch.cat([pos_l, neg_l], dim=-1)
    return torch.mean(torch.logsumexp(logits, -1) - logits[..., 0])


def seqrec_sampled_loss(p: dict, cfg: SeqRecConfig, item_ids: torch.Tensor,
                        targets: torch.Tensor,
                        neg_ids: torch.Tensor) -> torch.Tensor:
    """Sampled softmax: score positives vs ``n_neg`` shared negatives.
    item_ids (B, S); targets (B, S); neg_ids (n_neg,)."""
    h = seqrec_encode(p, cfg, item_ids)                    # (B, S, d)
    return _sampled_softmax(h, p["item_emb"][targets.long()],
                            p["item_emb"][neg_ids.long()])


def seqrec_score_candidates(p: dict, cfg: SeqRecConfig,
                            item_ids: torch.Tensor,
                            cand_ids: torch.Tensor) -> torch.Tensor:
    """retrieval_cand: item_ids (B, S) context; cand_ids (C,) -> (B, C)
    scores, one batched matmul against candidate embeddings."""
    h = seqrec_encode(p, cfg, item_ids)[:, -1, :]          # (B, d)
    return h @ p["item_emb"][cand_ids.long()].T


# -- BST: target-aware CTR scoring ---------------------------------------------

def bst_forward(p: dict, cfg: SeqRecConfig, item_ids: torch.Tensor,
                target_ids: torch.Tensor) -> torch.Tensor:
    """BST scores (history, target) pairs: the target item is appended to
    the behavior sequence before the transformer (the paper's layout), then
    [seq-pool, target-emb] feeds the MLP head.  Returns logits (B,)."""
    S = item_ids.shape[1]
    tgt_e = p["item_emb"][target_ids.long()]               # (B, d)
    x = p["item_emb"][item_ids.long()]
    x = torch.cat([x, tgt_e[:, None, :]], dim=1)           # (B, S+1, d)
    x = x + F.pad(p["pos_emb"], (0, 0, 0, 1))[None, :S + 1]
    for b in p["blocks"]:
        x = _block(b, x, cfg.n_heads, causal=False, p_bf16=cfg.p_bf16)
    x = _ln(x, p["ln_f"])
    h = torch.cat([x.mean(dim=1), tgt_e], dim=-1)
    for i, (w, bb) in enumerate(zip(p["mlp_w"], p["mlp_b"])):
        h = h @ w + bb
        if i < len(p["mlp_w"]) - 1:
            h = F.leaky_relu(h, 0.01)               # jax.nn.leaky_relu's slope
    return h[:, 0]


def bst_loss(p, cfg, item_ids, target_ids, labels):
    return _bce_with_logits(bst_forward(p, cfg, item_ids, target_ids),
                            labels)


# -- BERT4Rec masked training ---------------------------------------------------

def bert4rec_masked_loss(p: dict, cfg: SeqRecConfig, item_ids: torch.Tensor,
                         mask_pos: torch.Tensor, mask_targets: torch.Tensor,
                         neg_ids: torch.Tensor) -> torch.Tensor:
    """item_ids (B, S) with [MASK]=0 holes; mask_pos (B, M) positions;
    mask_targets (B, M) true items; sampled softmax at masked positions."""
    h = seqrec_encode(p, cfg, item_ids)                    # (B, S, d)
    hm = torch.gather(h, 1, mask_pos.long()[..., None].expand(
        *mask_pos.shape, h.shape[-1]))                     # (B, M, d)
    return _sampled_softmax(hm, p["item_emb"][mask_targets.long()],
                            p["item_emb"][neg_ids.long()])
