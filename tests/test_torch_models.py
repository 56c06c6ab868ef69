"""The port's model layers, GCN and recsys models, against the JAX package.

The same inputs, drawn from a seeded numpy generator, go through the JAX
package's function and its counterpart in ``repro_torch.models`` on the
CPU; parameters made by the JAX package's initializers are carried across
by ``repro_torch.models.convert`` (bf16 through float32, bit-exact).
Tolerances: atol = rtol = 2e-2 where the values are bf16, 1e-5 where they
are float32.

The layer functions run eagerly on both sides, op by op, each op rounded
to its dtype.  The MoE FFN covers a forced tie among the router's gates
(``jax.lax.top_k`` takes the lower index first; so does the port's stable
sort) and a forced capacity overflow (tokens past C dropped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_jax
from repro.models import gnn as GJ
from repro.models import layers as LJ
from repro.models import moe as MJ
from repro.models import recsys as RJ

from repro_torch.configs import get_arch
from repro_torch.models import gnn as GT
from repro_torch.models import layers as LT
from repro_torch.models import moe as MT
from repro_torch.models import recsys as RT
from repro_torch.models.convert import tensor_from_numpy, tree_from_numpy

BF16 = ml_dtypes.bfloat16
TOL = {"bf16": dict(rtol=2e-2, atol=2e-2), "f32": dict(rtol=1e-5, atol=1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size torch ops here gain nothing from threads, and idle
    OpenMP threads spinning beside the other test workers' processes
    slowed every file in a parallel run (about 2x); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got: torch.Tensor, want, kind: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[kind])


def _normal(rng, shape, scale=1.0, dtype=BF16):
    return (rng.normal(size=shape) * scale).astype(dtype)


# -- the weight carrier ---------------------------------------------------------

def test_bf16_round_trip_bit_exact():
    """bf16 numpy -> torch.bfloat16 (through float32) -> numpy is the
    identity on every bit pattern that is a number, subnormals and
    infinities included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    a = bits.view(BF16)
    a = a[~np.isnan(a.astype(np.float32))]
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    back = t.float().numpy().astype(BF16)
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
    f = np.arange(6, dtype=np.float32)
    assert tensor_from_numpy(f, "cpu").dtype == torch.float32
    tree = tree_from_numpy({"w": [f, a[:3]], "b": {"c": f}}, "cpu")
    assert tree["w"][1].dtype == torch.bfloat16
    assert tree["b"]["c"].dtype == torch.float32


def test_lm_params_carried_leaf_for_leaf():
    from repro.models import transformer as TJ
    from repro_torch.models.convert import lm_params_from_numpy
    cfg = get_arch_jax("qwen3-32b").smoke_config
    tree = jax.tree.map(np.asarray, TJ.init_params(jax.random.key(0), cfg))
    model = lm_params_from_numpy(tree, get_arch("qwen3-32b").smoke_config,
                                 "cpu")
    for i, blk in enumerate(model.blocks):
        for group in ("attn", "ffn"):
            for k, v in getattr(blk, group).items():
                np.testing.assert_array_equal(
                    v.float().numpy(),
                    tree["layers"][group][k][i].astype(np.float32))
    np.testing.assert_array_equal(model.unembed.float().numpy(),
                                  tree["unembed"].astype(np.float32))
    bad = dict(tree, layers=dict(tree["layers"], attn={
        k: v for k, v in tree["layers"]["attn"].items() if k != "q_norm"}))
    with pytest.raises(ValueError, match="attn leaves"):
        lm_params_from_numpy(bad, get_arch("qwen3-32b").smoke_config, "cpu")


# -- layers ----------------------------------------------------------------------

def test_rms_norm(rng):
    x = _normal(rng, (2, 8, 64))
    s = (1 + 0.1 * rng.normal(size=(64,))).astype(BF16)
    _close(LT.rms_norm(_t(x), _t(s)), LJ.rms_norm(jnp.asarray(x),
                                                  jnp.asarray(s)), "bf16")
    xf = rng.normal(size=(4, 32)).astype(np.float32)
    _close(LT.rms_norm(_t(xf), _t(s[:32].astype(np.float32))),
           LJ.rms_norm(jnp.asarray(xf), jnp.asarray(s[:32], jnp.float32)),
           "f32")


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(rng, theta):
    pos = rng.integers(0, 40_000, size=(2, 8)).astype(np.int32)
    cj, sj = LJ.rope_angles(jnp.asarray(pos), 16, theta)
    ct, st = LT.rope_angles(_t(pos), 16, theta)
    _close(ct, cj, "f32")
    _close(st, sj, "f32")
    x = _normal(rng, (2, 8, 3, 16))
    _close(LT.apply_rope(_t(x), ct, st), LJ.apply_rope(jnp.asarray(x), cj,
                                                       sj), "bf16")
    # the two halves rotate together, not interleaved pairs
    e = np.zeros((1, 1, 1, 16), np.float32)
    e[..., 0] = 1.0
    c = torch.full((1, 1, 8), np.cos(0.5))
    s = torch.full((1, 1, 8), np.sin(0.5))
    out = LT.apply_rope(torch.from_numpy(e), c, s)[0, 0, 0]
    assert out[8] == pytest.approx(np.sin(0.5))
    assert out[1] == 0


def test_dense_and_swiglu(rng):
    x = _normal(rng, (2, 8, 64))
    w = _normal(rng, (64, 96), 0.125)
    _close(LT.dense(_t(x), _t(w)), LJ.dense(jnp.asarray(x), jnp.asarray(w)),
           "bf16")
    # the reference's bf16_combine form rounds the same f32 sum once
    _close(LT.dense(_t(x), _t(w)),
           LJ.dense(jnp.asarray(x), jnp.asarray(w), bf16_combine=True),
           "bf16")
    _close(LT.matmul_f32(_t(x), _t(w)),
           jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.float32), "f32")
    wg, wu = _normal(rng, (64, 160), 0.125), _normal(rng, (64, 160), 0.125)
    wd = _normal(rng, (160, 64), 0.08)
    _close(LT.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           LJ.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), "bf16")


@pytest.mark.parametrize("window,chunk,p_bf16", [
    (None, 8, False), (5, 8, False), (None, 5, True), (3, 16, False),
    (None, 64, False)])
def test_flash_attention(rng, window, chunk, p_bf16):
    """Several chunks (a padded last one where 20 % chunk != 0), the
    window masking whole chunks of early rows, bf16 probability tiles."""
    q, k, v = (_normal(rng, (2, 20, 4, 16)) for _ in range(3))
    want = LJ.flash_attention(*map(jnp.asarray, (q, k, v)), kv_chunk=chunk,
                              window=window, p_bf16=p_bf16)
    got = LT.flash_attention(_t(q), _t(k), _t(v), kv_chunk=chunk,
                             window=window, p_bf16=p_bf16)
    _close(got, want, "bf16")


def test_repeat_kv(rng):
    k = _normal(rng, (2, 5, 3, 4))
    for n in (1, 4):
        _close(LT.repeat_kv(_t(k), n), LJ.repeat_kv(jnp.asarray(k), n),
               "bf16")


def _gqa_params(qk_norm: bool):
    p = LJ.init_gqa(jax.random.key(3), 64, 4, 2, 16, qk_norm)
    if qk_norm:   # non-trivial norm scales
        p["q_norm"] = p["q_norm"] * 1.5
        p["k_norm"] = p["k_norm"] * 0.75
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_gqa_attention(rng, qk_norm, window):
    pj, pt = _gqa_params(qk_norm)
    x = _normal(rng, (2, 12, 64))
    pos = np.arange(12, dtype=np.int32)[None]
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e6, kv_chunk=8,
              window=window)
    _close(LT.gqa_attention(pt, _t(x), _t(pos), **kw),
           LJ.gqa_attention(pj, jnp.asarray(x), jnp.asarray(pos), **kw),
           "bf16")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_decode_ring(rng, qk_norm):
    """Steps past ``S_cache``: the write wraps around the ring and every
    slot becomes valid; per-lane positions differ, one lane starts at 0.
    Also with ``kv_len`` cut to the last valid slot (same values)."""
    pj, pt = _gqa_params(qk_norm)
    S = 6
    ck = _normal(rng, (3, S, 2, 16))
    cv = _normal(rng, (3, S, 2, 16))
    cjk, cjv = jnp.asarray(ck), jnp.asarray(cv)
    ctk, ctv = _t(ck).clone(), _t(cv).clone()
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4)
    for step in range(9):
        pos = np.asarray([step, step + 2, 3 + 2 * step], np.int32)
        x = _normal(rng, (3, 1, 64))
        oj, cjk, cjv = LJ.gqa_decode(pj, jnp.asarray(x), cjk, cjv,
                                     jnp.asarray(pos), **kw)
        kv_len = min(int(pos.max()) + 1, S) if step % 2 else None
        ot, ctk, ctv = LT.gqa_decode(pt, _t(x), ctk, ctv, _t(pos),
                                     kv_len=kv_len, **kw)
        _close(ot, oj, "bf16")
        _close(ctk, cjk, "bf16")
        _close(ctv, cjv, "bf16")


def _mla_params():
    dims = dict(kv_lora_rank=16, nope_dim=16, rope_dim=8, v_dim=16)
    p = LJ.init_mla(jax.random.key(4), 64, 4, q_lora_rank=32, **dims)
    p["kv_a_norm"] = p["kv_a_norm"] * 1.25          # non-trivial norm scale
    return p, {k: _t(v) for k, v in p.items()}, dims


@pytest.mark.parametrize("window", [None, 5])
def test_mla_attention(rng, window):
    pj, pt, dims = _mla_params()
    x = _normal(rng, (2, 10, 64))
    pos = np.arange(10, dtype=np.int32)[None]
    kw = dict(n_heads=4, rope_theta=1e4, kv_chunk=4, window=window, **dims)
    _close(LT.mla_attention(pt, _t(x), _t(pos), **kw),
           LJ.mla_attention(pj, jnp.asarray(x), jnp.asarray(pos), **kw),
           "bf16")


def test_mla_decode_ring(rng):
    pj, pt, dims = _mla_params()
    S = 5
    c1, c2 = _normal(rng, (2, S, 16)), _normal(rng, (2, S, 8))
    j1, j2 = jnp.asarray(c1), jnp.asarray(c2)
    t1, t2 = _t(c1).clone(), _t(c2).clone()
    kw = dict(n_heads=4, rope_theta=1e4, **dims)
    for step in range(7):
        pos = np.asarray([step, 2 * step + 1], np.int32)
        x = _normal(rng, (2, 1, 64))
        oj, j1, j2 = LJ.mla_decode(pj, jnp.asarray(x), j1, j2,
                                   jnp.asarray(pos), **kw)
        ot, t1, t2 = LT.mla_decode(pt, _t(x), t1, t2, _t(pos),
                                   kv_len=min(int(pos.max()) + 1, S), **kw)
        _close(ot, oj, "bf16")
        _close(t1, j1, "bf16")
        _close(t2, j2, "bf16")


# -- MoE ------------------------------------------------------------------------

def _moe(p_np, x, **kw):
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: _t(v) for k, v in p_np.items()}
    oj, aj = MJ.moe_ffn(pj, jnp.asarray(x), **kw)
    ot, at = MT.moe_ffn(pt, _t(x), **kw)
    _close(ot, oj, "bf16")
    _close(at, aj, "f32")
    return ot


def _moe_params(rng, d=32, f=24, E=5):
    p = MJ.init_moe(jax.random.key(5), d, f, E)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("T,k,groups", [(16, 2, 1), (24, 2, 3), (10, 3, 4)])
def test_moe_ffn(rng, T, k, groups):
    p = _moe_params(rng)
    x = _normal(rng, (T, 32))
    _moe(p, x, n_experts=5, top_k=k, capacity_factor=1.25,
         num_groups=groups)


def test_moe_ffn_tie_takes_lower_index(rng):
    """A zero router gives every expert the same gate: ``jax.lax.top_k``
    picks experts 0..k-1; so must the port.  A router whose columns 1 and 3
    are equal ties those two for every token."""
    p = _moe_params(rng)
    x = _normal(rng, (12, 32))
    p0 = dict(p, router=np.zeros_like(p["router"]))
    vals, idx = MT._top_k(torch.full((2, 5), 0.2), 3)
    assert idx.tolist() == [[0, 1, 2]] * 2
    out = _moe(p0, x, n_experts=5, top_k=2, capacity_factor=5.0)
    assert torch.isfinite(out.float()).all()
    p13 = dict(p)
    p13["router"] = p["router"].copy()
    p13["router"][:, 3] = p13["router"][:, 1]
    _moe(p13, x, n_experts=5, top_k=2, capacity_factor=2.0)
    g = torch.softmax(_t(x).float() @ _t(p13["router"]), -1)
    assert (g[:, 1] == g[:, 3]).all()


def test_moe_ffn_capacity_overflow(rng):
    """A router that sends every token to expert 2 first: C = 1 slot per
    expert, so all but the first token's first choice overflow to slot C
    and are dropped, in token order."""
    p = _moe_params(rng)
    r = np.zeros_like(p["router"])
    r[:, 2] = 1.0
    p2 = dict(p, router=r)
    x = np.abs(_normal(rng, (8, 32))) + 0.5        # positive: expert 2 wins
    out = _moe(p2, x.astype(BF16), n_experts=5, top_k=1,
               capacity_factor=0.5)
    kept = out.float().abs().sum(-1) > 0
    assert kept.tolist() == [True] + [False] * 7


def test_moe_ffn_refuses_mesh(rng):
    """A mesh that is not the port's ``Mesh`` is refused; ``tp_axis``
    without a mesh is the reference's layout constraint on the grouped
    path, which changes no value."""
    p = {k: _t(v) for k, v in _moe_params(rng).items()}
    x = _t(_normal(rng, (4, 32)))
    for kw in ({"mesh": object()}, {"mesh": object(), "tp_axis": "model"}):
        with pytest.raises(TypeError, match="Mesh"):
            MT.moe_ffn(p, x, n_experts=5, top_k=2, **kw)
    want = MT.moe_ffn(p, x, n_experts=5, top_k=2)
    got = MT.moe_ffn(p, x, n_experts=5, top_k=2, tp_axis="model",
                     dp_spec="data")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- GCN --------------------------------------------------------------------------

def _gcn(cfg_name="gcn-cora"):
    cfg = get_arch_jax(cfg_name).smoke_config
    pj = GJ.init_params(jax.random.key(0), cfg)
    return cfg, pj, tree_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def test_gcn_full_graph_forward_and_loss(rng):
    cfg, pj, pt = _gcn()
    N, E = 40, 160
    src = rng.integers(0, N, size=E)
    dst = rng.integers(0, N, size=E)
    norm = GJ.edge_norm_for(src, dst, N, cfg.aggregator)
    np.testing.assert_array_equal(
        GT.edge_norm_for(src, dst, N, cfg.aggregator), norm)
    np.testing.assert_array_equal(GT.edge_norm_for(src, dst, N, "mean"),
                                  GJ.edge_norm_for(src, dst, N, "mean"))
    feats = rng.normal(size=(N, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, size=N).astype(np.int32)
    mask = (rng.random(N) < 0.5).astype(np.float32)
    aj = tuple(map(jnp.asarray, (feats, src, dst, norm)))
    at = tuple(map(_t, (feats, src, dst, norm)))
    _close(GT.forward(pt, cfg, *at), GJ.forward(pj, cfg, *aj), "f32")
    _close(GT.loss_fn(pt, cfg, *at, _t(labels), _t(mask)),
           GJ.loss_fn(pj, cfg, *aj, jnp.asarray(labels), jnp.asarray(mask)),
           "f32")


def test_gcn_sampler_and_minibatch(rng):
    cfg, pj, pt = _gcn()
    N, E = 200, 1200
    src = rng.integers(0, N, size=E)
    dst = rng.integers(0, N, size=E)
    gj, gt = GJ.CSRGraph(src, dst, N), GT.CSRGraph(src, dst, N)
    np.testing.assert_array_equal(gt.nbr, gj.nbr)
    np.testing.assert_array_equal(gt.offsets, gj.offsets)
    seeds = rng.choice(N, size=8, replace=False)
    fj = GJ.sample_subgraph(gj, seeds, [3, 2], np.random.default_rng(7))
    ft = GT.sample_subgraph(gt, seeds, [3, 2], np.random.default_rng(7))
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    feats = rng.normal(size=(ft[-1].size, cfg.d_feat)).astype(np.float32)
    out = GT.minibatch_forward(pt, cfg, _t(feats), [3, 2])
    assert out.shape == (8, cfg.n_classes)
    _close(out, GJ.minibatch_forward(pj, cfg, jnp.asarray(feats), [3, 2]),
           "f32")


def test_gcn_molecule_batched(rng):
    """Batched small graphs through per-graph offsets: one flat
    scatter-add, and no message crosses graphs."""
    cfg, pj, pt = _gcn()
    B, n, e = 16, 8, 20
    src = np.concatenate([rng.integers(0, n, size=e) + g * n
                          for g in range(B)])
    dst = np.concatenate([rng.integers(0, n, size=e) + g * n
                          for g in range(B)])
    N = B * n
    norm = GT.edge_norm_for(src, dst, N, "mean")
    feats = rng.normal(size=(N, cfg.d_feat)).astype(np.float32)
    got = GT.forward(pt, cfg, *map(_t, (feats, src, dst, norm)))
    _close(got, GJ.forward(pj, cfg, *map(jnp.asarray,
                                         (feats, src, dst, norm))), "f32")
    feats2 = feats.copy()
    feats2[:n] = 0
    got2 = GT.forward(pt, cfg, *map(_t, (feats2, src, dst, norm)))
    torch.testing.assert_close(got2[n:], got[n:], rtol=0, atol=0)


def test_gcn_init_law():
    cfg = get_arch("gcn-cora").smoke_config
    p = GT.init_params(cfg, torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in p["w"]] == [(cfg.d_feat, cfg.d_hidden),
                                                (cfg.d_hidden, cfg.n_classes)]
    again = GT.init_params(cfg, torch.Generator().manual_seed(0))
    torch.testing.assert_close(p["w"][0], again["w"][0], rtol=0, atol=0)


# -- recsys -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag(rng, mode):
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = np.asarray([3, 7, 7, 1, 0, 9], dtype=np.int32)
    offs = np.asarray([0, 2, 2, 5, 6], dtype=np.int32)  # an empty bag
    got = RT.embedding_bag(_t(table), _t(idx), _t(offs), mode)
    _close(got, RJ.embedding_bag(*map(jnp.asarray, (table, idx, offs)),
                                 mode=mode), "f32")
    want = torch.nn.functional.embedding_bag(
        _t(idx).long(), _t(table), _t(offs[:-1]).long(), mode=mode)
    _close(got, want.numpy(), "f32")
    ids2 = idx[:4].reshape(2, 2)
    _close(RT.embedding_bag_fixed(_t(table), _t(ids2), mode),
           RJ.embedding_bag_fixed(jnp.asarray(table), jnp.asarray(ids2),
                                  mode), "f32")


def test_deepfm_forward_and_loss(rng):
    cfg = get_arch_jax("deepfm").smoke_config
    pj = RJ.deepfm_init(jax.random.key(0), cfg)
    pt = tree_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    B = 32
    offs = np.concatenate([[0], np.cumsum(cfg.field_vocabs)[:-1]])
    ids = (rng.integers(0, 64, size=(B, cfg.n_fields)) + offs).astype(np.int32)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    _close(RT.deepfm_forward(pt, cfg, _t(ids)),
           RJ.deepfm_forward(pj, cfg, jnp.asarray(ids)), "f32")
    _close(RT.deepfm_loss(pt, cfg, _t(ids), _t(labels)),
           RJ.deepfm_loss(pj, cfg, jnp.asarray(ids), jnp.asarray(labels)),
           "f32")
    pi = RT.deepfm_init(get_arch("deepfm").smoke_config,
                        torch.Generator().manual_seed(0))
    assert pi["table"].shape == (cfg.total_rows(), cfg.embed_dim)


def _seqrec(name, p_bf16=False):
    cfg = get_arch_jax(name).smoke_config
    if p_bf16:
        cfg = dataclasses.replace(cfg, p_bf16=True)
    pj = RJ.seqrec_init(jax.random.key(0), cfg)
    return cfg, pj, tree_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("name,p_bf16", [("sasrec", False),
                                         ("bert4rec", False),
                                         ("sasrec", True)])
def test_seqrec_losses_and_retrieval(rng, name, p_bf16):
    cfg, pj, pt = _seqrec(name, p_bf16)
    B = 8
    seq = rng.integers(0, cfg.n_items, size=(B, cfg.seq_len)).astype(np.int32)
    negs = rng.integers(0, cfg.n_items, size=(cfg.n_neg,)).astype(np.int32)
    kind = "bf16" if p_bf16 else "f32"
    _close(RT.seqrec_encode(pt, cfg, _t(seq)),
           RJ.seqrec_encode(pj, cfg, jnp.asarray(seq)), kind)
    if name == "bert4rec":
        mpos = rng.integers(0, cfg.seq_len, size=(B, 4)).astype(np.int32)
        mtgt = rng.integers(0, cfg.n_items, size=(B, 4)).astype(np.int32)
        _close(RT.bert4rec_masked_loss(pt, cfg, *map(_t, (seq, mpos, mtgt,
                                                          negs))),
               RJ.bert4rec_masked_loss(pj, cfg, *map(jnp.asarray, (
                   seq, mpos, mtgt, negs))), kind)
    else:
        tgt = rng.integers(0, cfg.n_items,
                           size=(B, cfg.seq_len)).astype(np.int32)
        _close(RT.seqrec_sampled_loss(pt, cfg, *map(_t, (seq, tgt, negs))),
               RJ.seqrec_sampled_loss(pj, cfg, *map(jnp.asarray,
                                                    (seq, tgt, negs))), kind)
    cands = rng.integers(0, cfg.n_items, size=(64,)).astype(np.int32)
    _close(RT.seqrec_score_candidates(pt, cfg, _t(seq), _t(cands)),
           RJ.seqrec_score_candidates(pj, cfg, jnp.asarray(seq),
                                      jnp.asarray(cands)), kind)


def test_bst_forward_and_loss(rng):
    cfg, pj, pt = _seqrec("bst")
    B = 8
    seq = rng.integers(0, cfg.n_items, size=(B, cfg.seq_len)).astype(np.int32)
    tgt = rng.integers(0, cfg.n_items, size=(B,)).astype(np.int32)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    _close(RT.bst_forward(pt, cfg, _t(seq), _t(tgt)),
           RJ.bst_forward(pj, cfg, jnp.asarray(seq), jnp.asarray(tgt)),
           "f32")
    _close(RT.bst_loss(pt, cfg, _t(seq), _t(tgt), _t(labels)),
           RJ.bst_loss(pj, cfg, *map(jnp.asarray, (seq, tgt, labels))),
           "f32")
    pi = RT.seqrec_init(get_arch("bst").smoke_config,
                        torch.Generator().manual_seed(0))
    assert len(pi["mlp_w"]) == len(cfg.mlp_dims) + 1

