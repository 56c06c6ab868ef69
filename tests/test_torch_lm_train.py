"""The port's training path, against the JAX package.

* ``Transformer.lm_loss`` and its gradients against ``jax.value_and_grad``
  of ``repro``'s ``lm_loss`` for the five LM archs' smoke configs
  (``tests/test_archs_smoke.py``), from the same parameters (carried by
  ``models.convert``) and tokens.  ``repro`` is compiled with
  ``xla_allow_excess_precision`` off, as ``tests/test_torch_lm_models.py``
  compiles it.  Tolerances: the loss within 2e-2 relative (measured
  ~1e-7), each gradient leaf within 2e-2 × its max |g| (measured at most
  1.6e-2): the bf16 gradients are rounded at the same ops, but a bf16
  cotangent that meets several uses is summed in another order (the
  scatter-adds into ``embed`` among them), and those last-bit differences
  carry back through the layers;
* GCN's full-graph step and DeepFM's (``tests/test_archs_smoke.py``) in
  float32: loss and gradients within 1e-5, then one trainer step of each
  (parameters within 1e-5);
* five ``Trainer`` steps of yi-6b's smoke config in both packages from
  converted parameters on the same pipeline (``repro``'s step jitted
  strictly): losses within 2e-2 relative;
* the recomputed layers (``torch.utils.checkpoint``, as ``forward`` runs
  with gradients on) against autograd's kept activations: the same loss
  and gradients, bit for bit;
* the training tier's entry points on the CPU: ``launch/train.py
  --smoke`` (and its production mode refusing to run),
  ``launch/train_lm.py`` and ``launch/web_graph.py`` — the last against
  ``examples/web_graph.py``:
  the same printed edge count, rules and Re-Pair bytes, and GCN logits
  equal to ``repro``'s on converted parameters (1e-5, as
  ``tests/test_torch_models.py``'s GCN test).
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_jax
from repro.data import pipeline as PJ
from repro.models import gnn as GJ
from repro.models import recsys as RJ
from repro.models import transformer as TJ
from repro.train import loop as LJ
from repro.train import optimizer as OJ

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, ShardedTokenPipeline, \
    SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.launch import train_lm, web_graph
from repro_torch.models import gnn as GT
from repro_torch.models import recsys as RT
from repro_torch.models.convert import lm_params_from_numpy, tree_from_numpy
from repro_torch.train.loop import Trainer, TrainConfig, make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.tree import Stacked, leaves_with_paths, parts

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["qwen3-32b", "yi-6b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b"]
STRICT = {"xla_allow_excess_precision": False}
LM_TOL = 2e-2
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops gain nothing from threads beside the other
    test workers' processes; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    cfg = get_arch_jax(name).smoke_config
    params = TJ.init_params(jax.random.key(0), cfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_arch(name).smoke_config, "cpu")
    return cfg, params, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(model) -> dict:
    """The port's gradients by the reference's paths, stacked leaves
    stacked, as float32 numpy."""
    out = {}
    for path, leaf in leaves_with_paths(model):
        g = [p.grad for p in parts(leaf)]
        g = torch.stack(g) if isinstance(leaf, Stacked) else g[0]
        out[path] = g.float().numpy()
    return out


def _loss_and_grads(model, toks, tgt):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = model.lm_loss(torch.from_numpy(toks), torch.from_numpy(tgt))
    loss.backward()
    return loss.detach(), _grads(model)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_loss_and_grads_match_repro(name):
    cfg, params, model = _pair(name)
    toks, tgt = _tokens(cfg, (2, 16), 1), _tokens(cfg, (2, 16), 2)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: TJ.lm_loss(p, cfg, toks, tgt)),
        compiler_options=STRICT)(params)
    loss_t, grads_t = _loss_and_grads(model, toks, tgt)
    assert abs(float(loss_t) - float(loss_j)) <= LM_TOL * abs(float(loss_j))
    want = _flat(grads_j)
    assert sorted(grads_t) == sorted(want)
    for path, g in want.items():
        assert grads_t[path].shape == g.shape, path
        assert np.abs(g).max() > 0, path
        err = np.abs(grads_t[path] - g).max()
        assert err <= LM_TOL * np.abs(g).max(), (path, err)


@pytest.mark.parametrize("name", ["yi-6b", "granite-moe-3b-a800m"])
def test_recomputed_layers_give_the_same_gradients(name, monkeypatch):
    """Each layer recomputed in the backward (``torch.utils.checkpoint``,
    as ``forward`` runs it with gradients on) against autograd keeping
    every layer's activations (``checkpoint`` replaced by a plain call):
    the same loss and gradients, bit for bit, and the backward really runs
    each layer again."""
    from repro_torch.models import transformer
    cfg, _, model = _pair(name)
    toks, tgt = _tokens(cfg, (2, 16), 3), _tokens(cfg, (2, 16), 4)
    calls = []
    block = type(model.blocks[0])
    forward = block.forward

    def counted(self, *args):
        calls.append(1)
        return forward(self, *args)

    monkeypatch.setattr(block, "forward", counted)
    loss_on, on = _loss_and_grads(model, toks, tgt)
    assert len(calls) == 2 * cfg.n_layers          # forward + recompute
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    calls.clear()
    loss_off, off = _loss_and_grads(model, toks, tgt)
    assert len(calls) == cfg.n_layers
    assert float(loss_on) == float(loss_off)
    for path in on:
        np.testing.assert_array_equal(on[path], off[path], err_msg=path)


def _gcn_case(rng):
    cfg = get_arch_jax("gcn-cora").smoke_config
    N, E = 40, 160
    src = rng.integers(0, N, size=E)
    dst = rng.integers(0, N, size=E)
    norm = GJ.edge_norm_for(src, dst, N, cfg.aggregator)
    feats = rng.normal(size=(N, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, size=N).astype(np.int32)
    mask = (rng.random(N) < 0.5).astype(np.float32)
    args = (feats, src, dst, norm, labels, mask)
    pj = GJ.init_params(jax.random.key(0), cfg)

    def loss_j(p, a):
        return GJ.loss_fn(p, cfg, *map(jnp.asarray, a))

    def loss_t(p, a):
        return GT.loss_fn(p, cfg, *a)
    return pj, args, loss_j, loss_t


def _deepfm_case(rng):
    cfg = get_arch_jax("deepfm").smoke_config
    B = 32
    offs = np.concatenate([[0], np.cumsum(cfg.field_vocabs)[:-1]])
    ids = (rng.integers(0, 64, size=(B, cfg.n_fields)) + offs).astype(
        np.int32)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    pj = RJ.deepfm_init(jax.random.key(0), cfg)

    def loss_j(p, a):
        return RJ.deepfm_loss(p, cfg, *map(jnp.asarray, a))

    def loss_t(p, a):
        return RT.deepfm_loss(p, cfg, *a)
    return pj, (ids, labels), loss_j, loss_t


@pytest.mark.parametrize("case", [_gcn_case, _deepfm_case],
                         ids=["gcn_full_graph", "deepfm"])
def test_tree_model_step_matches_repro(case, rng):
    """Loss and gradients against ``jax.value_and_grad``, then one AdamW
    step of each package's train step on the same batch."""
    pj, args, loss_j, loss_t = case(rng)
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    pt = tree_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    lj, gj = jax.value_and_grad(loss_j)(pj, args)
    for leaf in jax.tree.leaves(pt):
        leaf.requires_grad_(True)
    lt = loss_t(pt, targs)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **F32)
    grads_t = {p: leaf.grad.numpy() for p, leaf in leaves_with_paths(pt)}
    for path, g in _flat(gj).items():
        np.testing.assert_allclose(grads_t[path], g, err_msg=path, **F32)

    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    pj2, _, mj = LJ.make_train_step(loss_j, OJ.AdamWConfig(**ocfg),
                                    donate=False)(
        pj, OJ.init_opt_state(pj), args)
    for leaf in jax.tree.leaves(pt):
        leaf.grad = None
    step = make_train_step(loss_t, AdamWConfig(**ocfg))
    pt2, st, mt = step(pt, init_opt_state(pt), targs)
    assert int(st.count) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), **F32)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), **F32)
    got = {p: leaf.detach().numpy() for p, leaf in leaves_with_paths(pt2)}
    for path, want in _flat(pj2).items():
        np.testing.assert_allclose(got[path], want, err_msg=path, **F32)


def test_trainer_steps_match_repro(tmp_path):
    """Five ``Trainer`` steps of yi-6b's smoke config in both packages."""
    cfg, params, model = _pair("yi-6b")
    kw = dict(seq_len=16, global_batch=4, vocab=cfg.vocab, seed=3)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    tcfg = dict(total_steps=5, ckpt_every=100, log_every=1000)
    tr_j = LJ.Trainer(
        lambda p, b: TJ.lm_loss(p, cfg, b["tokens"], b["targets"]), params,
        PJ.ShardedTokenPipeline(PJ.SyntheticLMDataset(PJ.DataConfig(**kw))),
        opt_cfg=OJ.AdamWConfig(**ocfg),
        train_cfg=LJ.TrainConfig(ckpt_dir=str(tmp_path / "j"), **tcfg))
    tr_j.step_fn = jax.jit(tr_j.step_fn.__wrapped__, donate_argnums=(0, 1),
                           compiler_options=STRICT)
    tr_t = Trainer(
        lambda m, b: m.lm_loss(b["tokens"], b["targets"]), model,
        ShardedTokenPipeline(SyntheticLMDataset(DataConfig(**kw))),
        opt_cfg=AdamWConfig(**ocfg),
        train_cfg=TrainConfig(ckpt_dir=str(tmp_path / "t"), **tcfg))
    hj, ht = tr_j.run(), tr_t.run()
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == \
        list(range(5))
    for a, b in zip(ht, hj):
        assert abs(a["loss"] - b["loss"]) <= LM_TOL * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= \
            LM_TOL * b["grad_norm"]
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert ht[-1]["loss"] < ht[0]["loss"]
    assert tr_t.ckpt.steps() == tr_j.ckpt.steps() == [5]


# -- the entry points on the CPU --------------------------------------------------------

def test_smoke_train_on_cpu(tmp_path):
    tr = launch_train.smoke_train("minicpm3-4b", 4, str(tmp_path), "cpu")
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert tr.ckpt.steps() == [2, 4]
    # run again on the same directory: it resumes where it stopped
    again = launch_train.smoke_train("minicpm3-4b", 6, str(tmp_path), "cpu")
    assert [h["step"] for h in again.history] == [4, 5]
    with pytest.raises(SystemExit, match="LM archs"):
        launch_train.smoke_train("gcn-cora", 2, str(tmp_path), "cpu")


def test_train_launcher_production_mode_refuses():
    """The default mode is the dry run of the full config on the
    production mesh (meta entries: nothing allocated, no card): it returns
    the cell's record, and refuses a shape the arch does not have."""
    rec = launch_train.main(["--arch", "yi-6b", "--device", "cpu",
                             "--multi-pod"])
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["shape"] == "train_4k" and rec["devices"] == 512
    with pytest.raises(KeyError, match="no shape"):
        launch_train.main(["--arch", "yi-6b", "--shape", "train_8k"])


def test_train_lm_demo_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = train_lm.main(["--steps", "60", "--batch", "4", "--seq",
                              "64", "--device", "cpu", "--ckpt-dir",
                              str(tmp_path)])
    out = buf.getvalue()
    assert len(hist) == 60 and out.rstrip().endswith("train_lm OK")
    assert "model lm-demo: " in out
    from repro_torch.models.transformer import Transformer
    assert sum(p.numel() for p in Transformer(train_lm.DEMO, "cpu")
               .parameters()) == train_lm.DEMO.param_count()
    ex = _example("train_lm")
    for mine, theirs in ((train_lm.FULL, ex.FULL), (train_lm.DEMO, ex.DEMO)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_web_graph_matches_the_example():
    ex = _example("web_graph")
    buf_j, buf_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_j):
        ex.main()
    with contextlib.redirect_stdout(buf_t):
        web_graph.main(device="cpu")
    lj, lt = buf_j.getvalue().splitlines(), buf_t.getvalue().splitlines()
    assert len(lj) == len(lt) and lt[-1] == "web_graph OK"
    # the same edge count, rules and bytes; only the builder's name differs
    assert [s.replace("jnp builder", "torch builder") for s in lj] == lt

    adj = web_graph.make_web_graph(600)
    for a, b in zip(adj, ex.make_web_graph(600)):
        np.testing.assert_array_equal(a, b)
    src = np.repeat(np.arange(600), [len(a) for a in adj])
    dst = np.concatenate(adj)
    cfg = GJ.GCNConfig(**dataclasses.asdict(web_graph.GCN))
    pj = GJ.init_params(jax.random.key(0), cfg)
    feats = np.random.default_rng(1).normal(
        size=(600, cfg.d_feat)).astype(np.float32)
    norm = GJ.edge_norm_for(src, dst, 600, cfg.aggregator)
    want = GJ.forward(pj, cfg, jnp.asarray(feats),
                      jnp.asarray(src.astype(np.int32)),
                      jnp.asarray(dst.astype(np.int32)), jnp.asarray(norm))
    got = web_graph.gcn_logits(tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), feats, src, dst, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
