"""The port's training substrate, against the JAX package.

Counterparts of the 16 tests of ``tests/test_train_infra.py`` (pipeline
determinism, checkpoint atomicity, integrity and restore onto an explicit
device, trainer crash-resume, straggler detection, gradient compression),
then the port held to ``repro`` on the CPU:

* the LM token pipeline's batches equal the reference's bit for bit, at
  every step, shard and shard count;
* checkpoints cross the packages bit for bit: one written by ``repro``'s
  ``Trainer`` restores into the port, one written by the port's
  ``Trainer`` restores into ``repro``, and the same state saved by both
  gives the same manifest (paths, shapes, dtype names, SHA-256 values);
* ``adamw_update`` on identical parameters and gradients, clipping off
  (the norm below ``clip_norm``): the moments bit-exact and the
  parameters within one bf16 ulp (in fact equal), with both
  ``bf16_update_gather`` branches, over three steps.  ``repro``'s update
  runs eagerly here: jitted, XLA fuses each moment's ``b·m + (1-b)·g``
  and from the second step it may differ in the last bit;
* the weight decay follows the rank of the reference's stacked leaf: every
  layer's ``ln1`` (rank 1 in a port block, ``(L, d)`` in the reference)
  is decayed and ``ln_f`` is not;
* ``lr_at`` within one float32 ulp; the global norm within 1e-5 relative
  (its sums run in another order); ``compress_int8`` equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as get_arch_jax
from repro.data import pipeline as PJ
from repro.models import transformer as TJ
from repro.train import checkpoint as CJ
from repro.train import loop as LJ
from repro.train import optimizer as OJ

from repro_torch.configs import get_arch
from repro_torch.data import (DataConfig, PipelineCursor,
                              ShardedTokenPipeline, SyntheticLMDataset)
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy, tree_from_numpy)
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import StepTimer, Trainer, TrainConfig
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         clip_by_global_norm, compress_int8,
                                         decompress_int8, init_opt_state,
                                         lr_at)
from repro_torch.train.tree import Stacked, leaves_with_paths

BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops gain nothing from threads beside the other
    test workers' processes; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- data pipeline ---------------------------------------------------------------

def test_pipeline_determinism():
    cfg = DataConfig(seq_len=8, global_batch=16, vocab=100, seed=7)
    ds = SyntheticLMDataset(cfg)
    b1 = ds.batch_at(3)
    b2 = ds.batch_at(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds.batch_at(4)["tokens"], b1["tokens"])


def test_pipeline_sharding_partitions_batch():
    cfg = DataConfig(seq_len=8, global_batch=16, vocab=100)
    ds = SyntheticLMDataset(cfg)
    full = ds.batch_at(0)["tokens"]
    parts = []
    for s in range(4):
        p = ShardedTokenPipeline(ds, shard_id=s, num_shards=4)
        parts.append(p.next_batch()["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_pipeline_cursor_resume():
    cfg = DataConfig(seq_len=8, global_batch=4, vocab=100)
    p1 = ShardedTokenPipeline(SyntheticLMDataset(cfg))
    for _ in range(5):
        p1.next_batch()
    state = p1.state_dict()
    p2 = ShardedTokenPipeline(SyntheticLMDataset(cfg))
    p2.load_state_dict(state)
    np.testing.assert_array_equal(p2.next_batch()["tokens"],
                                  SyntheticLMDataset(cfg).batch_at(5)["tokens"])
    assert PipelineCursor.from_dict(state).to_dict() == {"step": 5}


def test_elastic_rescale_preserves_global_stream():
    """512 -> 256 chips: different shard counts, same global batches."""
    cfg = DataConfig(seq_len=4, global_batch=32, vocab=50)
    ds = SyntheticLMDataset(cfg)
    b8 = [ShardedTokenPipeline(ds, s, 8).next_batch()["tokens"]
          for s in range(8)]
    b4 = [ShardedTokenPipeline(ds, s, 4).next_batch()["tokens"]
          for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(b8), np.concatenate(b4))


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_pipeline_batches_equal_repro(num_shards):
    """Every step, shard and shard count: the reference's batches, bit for
    bit (tokens and targets, dtype and shape)."""
    kw = dict(seq_len=12, global_batch=8, vocab=97, seed=5)
    for s in range(num_shards):
        pt = ShardedTokenPipeline(SyntheticLMDataset(DataConfig(**kw)), s,
                                  num_shards)
        pj = PJ.ShardedTokenPipeline(PJ.SyntheticLMDataset(
            PJ.DataConfig(**kw)), s, num_shards)
        assert pt.local_batch == pj.local_batch
        for _ in range(4):
            bt, bj = pt.next_batch(), pj.next_batch()
            assert sorted(bt) == sorted(bj) == ["targets", "tokens"]
            for k in bj:
                assert bt[k].dtype == bj[k].dtype
                np.testing.assert_array_equal(bt[k], bj[k])
        assert pt.state_dict() == pj.state_dict() == {"step": 4}


# -- checkpoint manager -----------------------------------------------------------

@pytest.fixture
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


def _state(key=0):
    g = torch.Generator().manual_seed(key)
    return {"w": torch.randn((8, 8), generator=g).to(torch.bfloat16),
            "b": torch.arange(4, dtype=torch.float32),
            "nested": {"t": torch.ones((2, 3), dtype=torch.int32)}}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy()


def _leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def test_checkpoint_roundtrip(ckpt_dir):
    cm = CheckpointManager(ckpt_dir)
    st = _state()
    cm.save(10, st, extra={"cursor": {"step": 10}})
    restored, extra = cm.restore(10, st)
    assert extra == {"cursor": {"step": 10}}
    for a, b in zip(_leaves(st), _leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


def test_checkpoint_versioning_and_gc(ckpt_dir):
    cm = CheckpointManager(ckpt_dir, retain=2)
    st = _state()
    for s in (1, 2, 3, 4):
        cm.save(s, st)
    assert cm.steps() == [3, 4]
    assert cm.latest() == 4


def test_checkpoint_atomicity_incomplete_ignored(ckpt_dir):
    cm = CheckpointManager(ckpt_dir)
    st = _state()
    cm.save(1, st)
    # simulate a crash mid-write: tmp dir exists without manifest
    tmp = os.path.join(ckpt_dir, "step_0000000002.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(b"partial")
    assert cm.latest() == 1  # incomplete step 2 is invisible
    # a completed dir missing its manifest is equally invisible
    half = os.path.join(ckpt_dir, "step_0000000003")
    os.makedirs(half)
    assert cm.latest() == 1


def test_checkpoint_corruption_detected(ckpt_dir):
    cm = CheckpointManager(ckpt_dir)
    st = _state()
    path = cm.save(5, st)
    npz = os.path.join(path, "arrays.npz")
    # corrupt a whole stretch of the payload (a single mid-file byte can
    # land in zip member padding and go unnoticed by np.load)
    data = bytearray(open(npz, "rb").read())
    for off in range(len(data) // 3, len(data) // 3 + 48):
        data[off] ^= 0xFF
    open(npz, "wb").write(bytes(data))
    with pytest.raises(Exception):
        cm.restore(5, st)


def test_checkpoint_restore_onto_explicit_device(ckpt_dir):
    """The counterpart of the reference's elastic re-sharding: restore onto
    an explicit device, into a target that holds only shapes and dtypes
    (tensors on the meta device)."""
    cm = CheckpointManager(ckpt_dir)
    st = _state()
    cm.save(1, st)
    shapes = {k: (v.to("meta") if torch.is_tensor(v) else
                  {kk: vv.to("meta") for kk, vv in v.items()})
              for k, v in st.items()}
    for target, device in ((shapes, "cpu"), (st, torch.device("cpu")),
                           (shapes, None)):
        restored, _ = cm.restore(1, target, device=device)
        for a, b in zip(_leaves(st), _leaves(restored)):
            assert b.device == torch.device("cpu") and a.dtype == b.dtype
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
    with pytest.raises(ValueError, match="saved"):
        cm.restore(1, {**st, "b": torch.zeros(5)})


# -- trainer ----------------------------------------------------------------------

def _tiny_trainer(ckpt_dir, steps, key=0):
    dcfg = DataConfig(seq_len=4, global_batch=4, vocab=32)
    pipe = ShardedTokenPipeline(SyntheticLMDataset(dcfg))
    g = torch.Generator().manual_seed(key)
    params = {"w": torch.randn((32, 32), generator=g) * 0.1}

    def loss_fn(p, batch):
        x = F.one_hot(batch["tokens"].long(), 32).float()
        logits = x @ p["w"]
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1,
                            batch["targets"].long()[..., None])[..., 0]
        return torch.mean(lse - gold)

    return Trainer(loss_fn, params, pipe,
                   opt_cfg=AdamWConfig(lr=1e-2, total_steps=steps,
                                       warmup_steps=2),
                   train_cfg=TrainConfig(total_steps=steps, ckpt_every=5,
                                         ckpt_dir=ckpt_dir, log_every=1000))


def test_trainer_loss_decreases(ckpt_dir):
    tr = _tiny_trainer(ckpt_dir, 60)
    hist = tr.run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first


def test_trainer_crash_resume_exact(ckpt_dir):
    """Uninterrupted run == crash-at-10 + resume, bit-exact."""
    tr_full = _tiny_trainer(ckpt_dir + "_a", 20)
    tr_full.run()
    w_full = tr_full.params["w"].detach().clone()

    tr1 = _tiny_trainer(ckpt_dir + "_b", 20)
    tr1.run(steps=10)  # "crash" after step 10 (ckpt_every=5 -> ckpt at 10)
    tr2 = _tiny_trainer(ckpt_dir + "_b", 20, key=99)  # fresh init
    hist = tr2.run()  # must restore at 10 and finish
    assert [h["step"] for h in hist] == list(range(10, 20))
    assert tr2.params["w"].requires_grad
    np.testing.assert_array_equal(tr2.params["w"].detach().numpy(),
                                  w_full.numpy())
    assert [h["loss"] for h in hist] == \
        [h["loss"] for h in tr_full.history[10:]]


def test_straggler_detection():
    t = StepTimer(window=8, factor=3.0)
    for i in range(8):
        assert not t.record(i, 0.1)
    assert t.record(8, 1.0)       # 10x median -> flagged
    assert t.flagged == [8]
    assert not t.record(9, 0.12)


def test_straggler_checkpoint_and_rebalance(ckpt_dir, monkeypatch):
    """Persistent stragglers trigger an immediate checkpoint."""
    tr = _tiny_trainer(ckpt_dir, 40)
    tr.cfg = TrainConfig(total_steps=40, ckpt_every=1000,  # periodic off
                         ckpt_dir=ckpt_dir, log_every=10000,
                         straggler_factor=2.0, straggler_ckpt_after=2)
    # inject synthetic step times: steps 20..22 are 10x slower
    real_record = tr.timer.record

    def fake_record(step, dt):
        return real_record(step, 1.0 if 20 <= step <= 22 else 0.01)

    tr.timer.record = fake_record
    tr.run(resume=False)
    # a checkpoint exists despite ckpt_every=1000 (straggler-triggered,
    # plus the final save at step 40)
    steps = tr.ckpt.steps()
    assert any(s <= 25 for s in steps), steps


# -- optimizer / gradient compression ----------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    for _ in range(60):
        grads = {"x": 2 * params["x"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 1.0


def test_lr_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(lr_at(cfg, 0)) == pytest.approx(0.1)
    assert float(lr_at(cfg, 9)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 110)) == pytest.approx(0.0, abs=1e-6)


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    q, s = compress_int8(g)
    assert q.dtype == torch.int8
    rec = decompress_int8(q, s)
    # quantization error bounded by scale/2 per element
    assert float((rec - g).abs().max()) <= float(s) * 0.5 + 1e-6
    # error feedback: accumulated error stays bounded over repeated rounds
    err = torch.zeros_like(g)
    total_out = torch.zeros_like(g)
    for _ in range(50):
        target = g + err
        q, s = compress_int8(target)
        out = decompress_int8(q, s)
        err = target - out
        total_out += out
    # long-run average transmitted == true gradient (unbiased)
    np.testing.assert_allclose(total_out.numpy() / 50, g.numpy(),
                               atol=float(s))


# -- held to repro -------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=110),
    dict(lr=3e-4, warmup_steps=100, total_steps=10000),
    dict(lr=1e-3, warmup_steps=5, total_steps=20),
    dict(lr=1e-2, warmup_steps=0, total_steps=7)])
def test_lr_at_matches_repro(cfg):
    """Every step of warmup, the cosine and past its end, against the
    reference's ``lr_at`` as written (op by op; jitted, XLA turns the
    divisions by constants into products by their reciprocals, another
    rounding).  Warmup is equal.  The two float32 ``cos`` differ by up to
    one ulp (measured: at most 1 over [0, pi]), which carries into at
    most one ulp of ``1 + cos``: the rate must be within ``0.5 · lr ·
    max(ulp(cos), ulp(1 + cos))`` plus one ulp of its own."""
    ct, cj = AdamWConfig(**cfg), OJ.AdamWConfig(**cfg)
    span = max(cfg["total_steps"] - cfg["warmup_steps"], 1)
    steps = range(0, cfg["total_steps"] + 3)
    got = lr_at(ct, torch.tensor(list(steps), dtype=torch.int32))
    want = np.asarray(OJ.lr_at(cj, jnp.asarray(list(steps), jnp.int32)))
    assert got.dtype == torch.float32
    for step, g, w in zip(steps, got.tolist(), want):
        if step < cfg["warmup_steps"]:
            assert g == float(w), step
            continue
        t = np.float32(min(max((step - cfg["warmup_steps"]) / span, 0), 1))
        c = np.cos(np.float32(np.pi) * t)
        tol = 0.5 * cfg["lr"] * float(max(np.spacing(np.abs(c)),
                                          np.spacing(np.float32(1 + c)))) \
            + float(np.spacing(w))
        assert abs(g - float(w)) <= tol, step


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_int8_matches_repro(seed):
    g = (np.random.default_rng(seed).normal(size=(33, 7)) * 3).astype(
        np.float32)
    qj, sj = OJ.compress_int8(jnp.asarray(g))
    qt, st = compress_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert np.float32(st) == np.float32(sj)
    np.testing.assert_array_equal(decompress_int8(qt, st).numpy(),
                                  np.asarray(OJ.decompress_int8(qj, sj)))


def test_clip_by_global_norm_matches_repro():
    rng = np.random.default_rng(3)
    tree = {"b": rng.normal(size=(5,)).astype(np.float32),
            "a": [rng.normal(size=(4, 3)).astype(np.float32),
                  rng.normal(size=(2,)).astype(np.float32)]}
    cj, nj = OJ.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 0.5)
    ct, nt = clip_by_global_norm(tree_from_numpy(tree, "cpu"), 0.5)
    assert abs(float(nt) - float(nj)) <= 1e-5 * float(nj)
    for (_, a), b in zip(leaves_with_paths(ct), jax.tree.leaves(cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def _smoke_pair(name="yi-6b"):
    cfg_j = get_arch_jax(name).smoke_config
    params = TJ.init_params(jax.random.key(0), cfg_j)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_arch(name).smoke_config, "cpu")
    return cfg_j, params, model


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(BF16)
    return t.numpy()


@pytest.mark.parametrize("gather", [False, True])
def test_adamw_update_matches_repro(gather):
    """Three steps from identical parameters (yi-6b's smoke tree) and
    identical gradients, clipping off: ``mu`` and ``nu`` bit-exact, every
    parameter within one bf16 ulp, the global norm within 1e-5."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1e6,
              bf16_update_gather=gather)
    cj, ct = OJ.AdamWConfig(**kw), AdamWConfig(**kw)
    _, pj, model = _smoke_pair()
    sj, st = OJ.init_opt_state(pj), init_opt_state(model)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(
            np.asarray(a).dtype), pj)
        pj, sj, mj = OJ.adamw_update(cj, pj, g, sj)
        model, st, mt = adamw_update(ct, model, tree_from_numpy(g, "cpu"), st)
        assert float(mt["lr"]) == float(mj["lr"])
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= \
            1e-5 * float(mj["grad_norm"])
        for moment_t, moment_j in ((st.mu, sj.mu), (st.nu, sj.nu)):
            flat_t = dict(leaves_with_paths(moment_t))
            for path, want in _flat(moment_j).items():
                np.testing.assert_array_equal(flat_t[path].numpy(), want,
                                              err_msg=path)
        got = _flat(lm_params_to_numpy(model))
        for path, want in _flat(pj).items():
            want = want.astype(np.float32)
            ulp = np.spacing(np.abs(want).astype(BF16)).astype(np.float32)
            assert np.all(np.abs(got[path] - want) <= ulp), path
    assert int(st.count) == int(sj.count) == 3


def test_weight_decay_follows_the_stacked_rank():
    """Zero gradients: the step is the decay alone.  The reference decays
    a leaf of rank >= 2, and its ``layers/ln1`` is ``(L, d)``: the port's
    rank-1 ``ln1`` of each block is decayed too (as repro does it), while
    ``ln_f``, rank 1 in both, is not."""
    kw = dict(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.5)
    cj, ct = OJ.AdamWConfig(**kw), AdamWConfig(**kw)
    _, pj, model = _smoke_pair()
    assert model.blocks[0].ln1.ndim == 1 and pj["layers"]["ln1"].ndim == 2
    zeros = jax.tree.map(jnp.zeros_like, pj)
    pj, _, _ = OJ.adamw_update(cj, pj, zeros, OJ.init_opt_state(pj))
    model, _, _ = adamw_update(ct, model, tree_from_numpy(
        jax.tree.map(np.asarray, zeros), "cpu"), init_opt_state(model))
    # ln1 == 1: decayed to 1 - 0.1 * 0.5 * 1 = 0.95, rounded to bf16
    want = np.float32(np.float32(1) - np.float32(0.1) * np.float32(0.5))
    for blk in model.blocks:
        np.testing.assert_array_equal(
            blk.ln1.float().numpy(), np.full(blk.ln1.shape, want, BF16))
        np.testing.assert_array_equal(blk.ln2.float().numpy(),
                                      blk.ln1.float().numpy())
    assert torch.all(model.ln_f == 1)
    np.testing.assert_array_equal(
        lm_params_to_numpy(model)["layers"]["ln1"],
        np.asarray(pj["layers"]["ln1"], np.float32))
    np.testing.assert_array_equal(lm_params_to_numpy(model)["ln_f"],
                                  np.asarray(pj["ln_f"], np.float32))


# -- checkpoints across the packages ---------------------------------------------------

def _lm_loss_j(cfg):
    return lambda p, b: TJ.lm_loss(p, cfg, b["tokens"], b["targets"])


def _lm_loss_t(model, batch):
    return model.lm_loss(batch["tokens"], batch["targets"])


def _pipes():
    kw = dict(seq_len=8, global_batch=2, vocab=256)
    return (PJ.ShardedTokenPipeline(PJ.SyntheticLMDataset(
                PJ.DataConfig(**kw))),
            ShardedTokenPipeline(SyntheticLMDataset(DataConfig(**kw))))


def _train_cfgs(d, steps):
    kw = dict(total_steps=steps, ckpt_every=steps, ckpt_dir=d,
              log_every=1000)
    return LJ.TrainConfig(**kw), TrainConfig(**kw)


def _same_state(jax_state: dict, port_state: dict) -> None:
    """Every leaf, by path: the same shape, dtype and bytes."""
    flat_t = {p: leaf.stack() if isinstance(leaf, Stacked) else leaf
              for p, leaf in leaves_with_paths(port_state)}
    flat_j = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(jax_state)[0]:
        flat_j["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)] = np.asarray(v)
    assert sorted(flat_t) == sorted(flat_j)
    for path, want in flat_j.items():
        got = _as_numpy(flat_t[path])
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_the_packages(tmp_path):
    """repro's Trainer writes, the port restores (and resumes); the port's
    Trainer writes, repro restores: bit for bit both ways.  The state
    repro wrote, saved again by the port, has repro's manifest."""
    cfg_j, pj, model = _smoke_pair()
    pipe_j, pipe_t = _pipes()
    d_j, d_t, d_again = (str(tmp_path / n) for n in ("j", "t", "again"))

    tcj, _ = _train_cfgs(d_j, 2)
    tr_j = LJ.Trainer(_lm_loss_j(cfg_j), pj, pipe_j,
                      opt_cfg=OJ.AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=2),
                      train_cfg=tcj)
    tr_j.run()
    # the port restores repro's checkpoint into its own state
    cm = CheckpointManager(d_j)
    assert cm.latest() == 2
    target = {"params": model, "opt": init_opt_state(model)}
    state, extra = cm.restore(2, target)
    assert state["params"] is model and isinstance(state["opt"], OptState)
    assert extra == {"cursor": {"step": 2}}
    _same_state({"params": tr_j.params, "opt": tr_j.opt_state}, state)
    # ... and writes it again in repro's format, hash for hash
    cm2 = CheckpointManager(d_again)
    cm2.save(2, state, extra=extra)
    assert _manifest(d_again, 2) == _manifest(d_j, 2)

    # the port's Trainer (fresh parameters) resumes from repro's files
    _, tct = _train_cfgs(d_j, 4)
    fresh = init_params(get_arch("yi-6b").smoke_config,
                        torch.Generator().manual_seed(1), "cpu")
    tr_t = Trainer(_lm_loss_t, fresh, pipe_t,
                   opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=4), train_cfg=tct)
    hist = tr_t.run()
    assert [h["step"] for h in hist] == [2, 3]
    assert tr_t.pipeline.state_dict() == {"step": 4}

    # repro restores the port's Trainer's checkpoint
    _, tct = _train_cfgs(d_t, 2)
    _, pj2, model2 = _smoke_pair()
    tr_t2 = Trainer(_lm_loss_t, model2, _pipes()[1],
                    opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=2), train_cfg=tct)
    tr_t2.run()
    restored, extra = CJ.CheckpointManager(d_t).restore(
        2, {"params": pj2, "opt": OJ.init_opt_state(pj2)})
    assert extra == {"cursor": {"step": 2}}
    _same_state(restored, tr_t2._state())
