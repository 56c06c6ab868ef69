"""The port's LM serving engine, against the JAX package's.

``repro_torch.serve.DecodeEngine`` and ``repro.serve.DecodeEngine`` serve
the same prompts with the same weights (the JAX package's ``init_params``
tree carried across by ``models.convert``), on the cases of
``tests/test_serve.py`` and on every LM arch.  The JAX engine's jitted
prefill and step are swapped for the same functions compiled with
``xla_allow_excess_precision`` off (see ``tests/test_torch_lm_models.py``)
and recorded.  Then:

* teacher-forced: the port's engine runs with its model's logits recorded
  and replaced by the JAX engine's, so both follow the same tokens; every
  prefill and step must see the same inputs (prompt; tokens, positions and
  live lanes), its logits must agree within 2e-2, and the finished
  requests must be the same, in the same order, of the same lengths;
* free: the port's engine picks its own tokens; wherever the JAX engine's
  top-2 margin exceeds the tolerance the tokens must be equal (a near tie
  may go either way, and the runs part there).

A case with a sliding window fills the ring to ``s_cache`` and retires the
lanes there.  Last, the launcher's ``--tier lm`` runs in a subprocess.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_jax
from repro.models import transformer as TJ
from repro.serve import DecodeEngine as EngineJax
from repro.serve import ServeConfig as ServeConfigJax

from repro_torch.configs import get_arch
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import DecodeEngine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
STRICT = {"xla_allow_excess_precision": False}
TOL = 2e-2
LM_ARCHS = ["qwen3-32b", "yi-6b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size torch ops here gain nothing from threads, and idle
    OpenMP threads spinning beside the other test workers' processes
    slowed every file in a parallel run (about 2x); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax(cfg, params, scfg, prompts):
    """The JAX engine over ``prompts``; returns (finished, events), one
    event per prefill and per step, each with its inputs and logits."""
    eng = EngineJax(params, cfg, ServeConfigJax(**dataclasses.asdict(scfg)))
    step = jax.jit(lambda p, t, c, pos: TJ.decode_step(p, cfg, t, c, pos),
                   compiler_options=STRICT)
    prefill = jax.jit(lambda p, t: TJ.prefill(p, cfg, t),
                      compiler_options=STRICT)
    events = []

    def rec_prefill(p, tokens):
        logits, cache = prefill(p, tokens)
        events.append(("prefill", (np.array(tokens),), None,
                       np.array(logits)))
        return logits, cache

    def rec_step(p, t, c, pos):
        logits, cache = step(p, t, c, pos)
        # copies: a jax array made from the engine's numpy state may share
        # its memory, which the engine updates after the step
        events.append(("step", (np.array(t), np.array(pos)),
                       eng.live.copy(), np.array(logits)))
        return logits, cache

    eng._prefill, eng._step = rec_prefill, rec_step
    for pr in prompts:
        eng.submit(pr)
    return eng.run_until_drained(), events


def _run_port(model, scfg, prompts, forced=None):
    """The port's engine on the CPU; with ``forced`` (the JAX events) its
    model's logits are recorded and replaced by the JAX engine's."""
    eng = DecodeEngine(model, scfg, device="cpu")
    events = []
    prefill, step = model.prefill, model.decode_step

    def rec_prefill(tokens):
        logits, cache = prefill(tokens)
        events.append(("prefill", (tokens.numpy().copy(),), None,
                       logits.numpy()))
        if forced is not None:
            logits = torch.tensor(forced[len(events) - 1][3])
        return logits, cache

    def rec_step(token, cache, position):
        logits, cache = step(token, cache, position)
        events.append(("step", (np.array(token), np.array(position)),
                       eng.live.copy(), logits.numpy()))
        if forced is not None:
            logits = torch.tensor(forced[len(events) - 1][3])
        return logits, cache

    model.prefill, model.decode_step = rec_prefill, rec_step
    try:
        for pr in prompts:
            eng.submit(pr)
        return eng.run_until_drained(), events
    finally:
        del model.prefill, model.decode_step


def _margin(row):
    top2 = np.sort(row)[-2:]
    return top2[1] - top2[0]


def _rows(ev):
    """(row index, logits row) of each lane an event chooses tokens for."""
    kind, _, live, logits = ev
    lanes = [0] if kind == "prefill" else np.nonzero(live)[0]
    return [(lane, logits[lane]) for lane in lanes]


def _check(name, scfg, prompts, **replace):
    cfg_j = dataclasses.replace(get_arch_jax(name).smoke_config, **replace)
    cfg_t = dataclasses.replace(get_arch(name).smoke_config, **replace)
    params = TJ.init_params(jax.random.key(0), cfg_j)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                 "cpu")
    done_j, ev_j = _run_jax(cfg_j, params, scfg, prompts)

    # teacher-forced: same inputs, logits within TOL, same finished list
    done_t, ev_t = _run_port(model, scfg, prompts, forced=ev_j)
    assert done_t == done_j
    assert [len(o) for o in done_t] == [len(o) for o in done_j]
    assert len(done_j) == len(prompts)
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j]
    for et, ej in zip(ev_t, ev_j):
        for a, b in zip(et[1], ej[1]):
            np.testing.assert_array_equal(a, b)
        if ej[2] is not None:
            np.testing.assert_array_equal(et[2], ej[2])
        np.testing.assert_allclose(et[3], ej[3], rtol=TOL, atol=TOL)

    # free: equal tokens wherever the JAX engine's margin exceeds TOL
    done_f, ev_f = _run_port(model, scfg, prompts)
    near_tie = False
    for ef, ej in zip(ev_f, ev_j):
        for (lane, row_f), (_, row_j) in zip(_rows(ef), _rows(ej)):
            if _margin(row_j) > TOL:
                assert np.argmax(row_f) == np.argmax(row_j), (ej[0], lane)
            elif np.argmax(row_f) != np.argmax(row_j):
                near_tie = True
        if near_tie:
            break
    if not near_tie:
        assert done_f == done_j
    return done_j


def test_continuous_batching_matches_jax():
    """``tests/test_serve.py``'s first case: 5 requests on 2 lanes."""
    prompts = [np.arange(1, 4 + i) % 256 for i in range(5)]
    outs = _check("yi-6b", ServeConfig(max_batch=2, s_cache=24,
                                       max_new_tokens=4), prompts)
    assert all(1 <= len(o) <= 4 for o in outs)


def test_greedy_matches_forward_and_jax():
    """``tests/test_serve.py``'s second case: the first generated token is
    the argmax of the prefill logits, in both engines."""
    prompt = np.asarray([3, 7, 11], dtype=np.int32)
    outs = _check("yi-6b", ServeConfig(max_batch=1, s_cache=16,
                                       max_new_tokens=2), [prompt])
    cfg = get_arch_jax("yi-6b").smoke_config
    params = TJ.init_params(jax.random.key(0), cfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_arch("yi-6b").smoke_config, "cpu")
    logits, _ = model.prefill(torch.from_numpy(prompt)[None, :])
    assert outs[0][0] == int(torch.argmax(logits[0]))


@pytest.mark.parametrize("name", LM_ARCHS)
def test_every_arch_matches_jax(name):
    """Six requests on three lanes, queueing (one prompt length, so the
    reference compiles one prefill; the yi-6b cases above take five)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, 6).astype(np.int32) for _ in range(6)]
    _check(name, ServeConfig(max_batch=3, s_cache=32, max_new_tokens=7),
           prompts)


def test_sliding_window_ring_retires_at_s_cache():
    """A window-sized ring cache: lanes decode until the ring is full
    (``s_cache`` positions) and retire there, with EOS out of reach."""
    prompts = [np.asarray([5, 9, 2, 7, 4], np.int32),
               np.asarray([8, 3, 6, 10, 12, 13], np.int32)]
    outs = _check("yi-6b", ServeConfig(max_batch=2, s_cache=8,
                                       max_new_tokens=16, eos_id=-1),
                  prompts, window=8)
    assert sorted(len(o) for o in outs) == [3, 4]


def test_engine_refuses_model_elsewhere(monkeypatch):
    """The engine serves the model where it lives, and moves nothing."""
    cfg = get_arch("yi-6b").smoke_config
    from repro_torch.models.transformer import init_params
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    import repro_torch.serve.engine as E
    monkeypatch.setattr(E, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="lives on cpu"):
        DecodeEngine(model, ServeConfig(max_batch=1, s_cache=8))
    assert model.device == torch.device("cpu")


def test_launcher_tier_lm_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tier", "lm",
         "--device", "cpu", "--n", "6"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[yi-6b on cpu] served 6 requests / " in out.stdout

