"""The port's five LM architectures, against the JAX package.

For each LM arch's smoke config the JAX package's ``init_params`` tree is
carried into a ``repro_torch`` ``Transformer`` (``models.convert``), and the
same seeded tokens go through ``forward``, ``prefill``, ``decode_step`` and
``lm_loss`` on both sides, held at the repo's own tolerance (atol = rtol =
2e-2, ``tests/test_archs_smoke.py``).

The JAX functions are compiled with ``xla_allow_excess_precision`` off.
With it on (XLA's default), XLA's CPU backend keeps the bf16 intermediates
of a fusion in float32 instead of rounding each op, which moves smoke-size
logits by up to about 0.04 (1% of their largest magnitude); PyTorch rounds
every op to its dtype, as the reference's source writes it.  Compiled
strictly, the two packages agree to about 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_jax
from repro.models import transformer as TJ

from repro_torch.configs import get_arch
from repro_torch.models import transformer as TT
from repro_torch.models.convert import lm_params_from_numpy

LM_ARCHS = ["qwen3-32b", "yi-6b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b"]
STRICT = {"xla_allow_excess_precision": False}
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size torch ops here gain nothing from threads, and idle
    OpenMP threads spinning beside the other test workers' processes
    slowed every file in a parallel run (about 2x); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strict(fn, *static):
    return jax.jit(fn, static_argnums=static, compiler_options=STRICT)


def _pair(name, **replace):
    cfg_j = dataclasses.replace(get_arch_jax(name).smoke_config, **replace)
    cfg_t = dataclasses.replace(get_arch(name).smoke_config, **replace)
    params = TJ.init_params(jax.random.key(0), cfg_j)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                 "cpu")
    return cfg_j, params, model


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_prefill_loss(name):
    cfg, params, model = _pair(name)
    toks = _tokens(cfg, (2, 16), 1)
    tgt = _tokens(cfg, (2, 16), 2)
    # one compiled program for the three reference functions
    (lj, aj), (pj, cj), loss_j = _strict(lambda p, t, g: (
        TJ.forward(p, cfg, t), TJ.prefill(p, cfg, t),
        TJ.lm_loss(p, cfg, t, g)))(params, toks, tgt)
    lt, at = model(torch.from_numpy(toks))
    assert lt.shape == (2, 16, cfg.padded_vocab) and lt.dtype == torch.float32
    _close(lt, lj)
    _close(at, aj)
    pt, ct = model.prefill(torch.from_numpy(toks))
    _close(pt, pj)
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape
        _close(ct[k], cj[k])
    _close(model.lm_loss(torch.from_numpy(toks), torch.from_numpy(tgt)),
           loss_j)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_steps(name):
    """Eight decode steps over a cache of 12 slots from zeros, lanes at
    different depths (one past ``S_cache``, wrapping the ring)."""
    cfg, params, model = _pair(name)
    B, S = 3, 12
    cache_j = {k: jnp.zeros(s.shape, s.dtype) for k, s in
               TJ.init_cache_shape(cfg, B, S).items()}
    cache_t = model.init_cache(B, S)
    assert {k: tuple(v.shape) for k, v in cache_t.items()} == \
        {k: v.shape for k, v in cache_j.items()}
    step = _strict(lambda p, t, c, pos: TJ.decode_step(p, cfg, t, c, pos))
    toks = _tokens(cfg, (8, B), 3)
    for i in range(8):
        pos = np.asarray([i, i + 3, i + 9], np.int32)
        lj, cache_j = step(params, toks[i], cache_j, pos)
        # positions on the host: the attention reads up to the last slot
        # any lane has; as a tensor on the device: all slots
        where = torch.from_numpy(pos) if i % 2 else pos
        lt, cache_t = model.decode_step(torch.from_numpy(toks[i]), cache_t,
                                        where)
        _close(lt, lj)
        for k in cache_j:
            _close(cache_t[k], cache_j[k])


@pytest.mark.parametrize("name", ["yi-6b", "minicpm3-4b"])
def test_sliding_window_forward(name):
    """long_500k's mode: windowed attention equals the reference's, and
    differs from full attention past the window."""
    cfg, params, model = _pair(name, window=4)
    toks = _tokens(cfg, (1, 16), 4)
    lj, _ = _strict(lambda p, t: TJ.forward(p, cfg, t))(params, toks)
    lt, _ = model(torch.from_numpy(toks))
    _close(lt, lj)
    full = lm_params_from_numpy(
        jax.tree.map(np.asarray, params),
        get_arch(name).smoke_config, "cpu")(torch.from_numpy(toks))[0]
    assert not torch.allclose(full, lt)


@pytest.mark.parametrize("flags", [{"bf16_combine": True},
                                   {"flash_p_bf16": True}])
def test_numerics_flags(flags):
    """``bf16_combine`` (bf16 logits) and ``flash_p_bf16`` change the
    numerics; the port follows the reference through both."""
    cfg, params, model = _pair("qwen3-32b", **flags)
    toks = _tokens(cfg, (2, 16), 5)
    lj, _ = _strict(lambda p, t: TJ.forward(p, cfg, t))(params, toks)
    lt, _ = model(torch.from_numpy(toks))
    _close(lt, lj)
    if flags.get("bf16_combine"):
        np.testing.assert_array_equal(
            lt.numpy(), lt.bfloat16().float().numpy())


def test_init_params_seeded():
    """The port's initializer: the reference's shapes and law, the same
    values for the same seed, different for another."""
    cfg = get_arch("granite-moe-3b-a800m").smoke_config
    a = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    shapes = jax.eval_shape(lambda k: TJ.init_params(k, cfg),
                            jax.random.key(0))
    assert tuple(a.embed.shape) == shapes["embed"].shape
    for k, s in shapes["layers"]["ffn"].items():
        assert tuple(a.blocks[0].ffn[k].shape) == s.shape[1:]
        assert a.blocks[0].ffn[k].dtype == (
            torch.float32 if k == "router" else torch.bfloat16)
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.unembed, c.unembed)
    assert float(a.embed.float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)

