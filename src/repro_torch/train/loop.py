"""Training loop: the step, checkpoint/restart, straggler telemetry.

The loop is model-agnostic: it takes a ``loss_fn(params, batch) ->
scalar tensor`` and wires AdamW, gradient clipping, periodic
checkpointing (atomic and versioned, with the data cursor inside) and
crash-exact resume.  ``params`` is a
:class:`~repro_torch.models.transformer.Transformer` or a tree of tensors
(GCN's and the recsys models' parameters); the trainer turns on their
gradients.

A step runs ``loss.backward()``, then ``adamw_update`` writes the
parameters and moments in place under ``no_grad`` (the counterpart of the
reference's ``donate_argnums``), then the gradients are cleared.  Its time
is taken on the host clock around work that ends in a synchronise of the
parameters' device.

Fault-tolerance contract (as the reference's):

* ``run()`` starts by probing the checkpoint directory; if a complete
  checkpoint exists it restores params, optimizer state and data cursor
  and continues — a preempted job loses at most ``ckpt_every`` steps;
* ``StepTimer`` records per-step wall times; steps slower than
  ``straggler_factor ×`` the trailing median are flagged, and
  ``straggler_ckpt_after`` flags in the trailing window checkpoint at once
  (checkpoint-and-rebalance).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from ..data.pipeline import ShardedTokenPipeline
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state
from .tree import device_of, leaves, parts


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_factor: float = 3.0
    retain: int = 3
    # checkpoint-and-rebalance trigger: after this many straggler flags in
    # the trailing window the loop checkpoints immediately (so the cluster
    # scheduler can evict the slow host and restart elsewhere with at most
    # one step lost).  0 disables.
    straggler_ckpt_after: int = 3


class StepTimer:
    """Trailing-window step timing; flags stragglers."""

    def __init__(self, window: int = 32, factor: float = 3.0):
        self.times: list[float] = []
        self.window = window
        self.factor = factor
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        slow = bool(hist) and dt > self.factor * float(np.median(hist))
        if slow:
            self.flagged.append(step)
        self.times.append(dt)
        return slow


def _trainable(params: Any) -> Any:
    for leaf in leaves(params):
        for p in parts(leaf):
            if p.is_floating_point():
                p.requires_grad_(True)
    return params


def _clear_grads(params: Any) -> None:
    for leaf in leaves(params):
        for p in parts(leaf):
            p.grad = None


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """Returns ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the parameters and moments are updated in place."""

    def step(params, opt_state: OptState, batch):
        loss = loss_fn(params, batch)
        loss.backward()
        params, opt_state, metrics = adamw_update(
            opt_cfg, params, None, opt_state)
        _clear_grads(params)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, loss_fn: Callable, params: Any,
                 pipeline: ShardedTokenPipeline,
                 opt_cfg: AdamWConfig | None = None,
                 train_cfg: TrainConfig | None = None):
        self.cfg = train_cfg or TrainConfig()
        self.opt_cfg = opt_cfg or AdamWConfig(
            total_steps=self.cfg.total_steps)
        self.pipeline = pipeline
        self.params = _trainable(params)
        self.device = device_of(params)
        self.opt_state = init_opt_state(params)
        self.step_fn = make_train_step(loss_fn, self.opt_cfg)
        self.ckpt = CheckpointManager(self.cfg.ckpt_dir,
                                      retain=self.cfg.retain)
        self.timer = StepTimer(factor=self.cfg.straggler_factor)
        self.history: list[dict] = []

    # -- fault tolerance -------------------------------------------------------

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def try_restore(self) -> int:
        """Resume from the newest complete checkpoint; returns start step."""
        latest = self.ckpt.latest()
        if latest is None:
            return 0
        state, extra = self.ckpt.restore(latest, self._state(),
                                         device=self.device)
        self.params = _trainable(state["params"])
        self.opt_state = state["opt"]
        self.pipeline.load_state_dict(extra["cursor"])
        return latest

    def save(self, step: int) -> None:
        self.ckpt.save(step, self._state(),
                       extra={"cursor": self.pipeline.state_dict()})

    # -- main loop ---------------------------------------------------------------

    def run(self, steps: int | None = None, resume: bool = True
            ) -> list[dict]:
        start = self.try_restore() if resume else 0
        end = steps if steps is not None else self.cfg.total_steps
        for step in range(start, end):
            batch = self.pipeline.next_batch()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            slow = self.timer.record(step, dt)
            rec = {"step": step, "time_s": dt, "straggler": slow,
                   **{k: float(v) for k, v in metrics.items()}}
            self.history.append(rec)
            if step % self.cfg.log_every == 0:
                print(f"step {step:5d}  loss {rec['loss']:.4f}  "
                      f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.1f}ms"
                      + ("  [STRAGGLER]" if slow else ""))
            # checkpoint-and-rebalance: persistent stragglers trigger an
            # immediate checkpoint so the scheduler can evict/replace the
            # slow host with at most one step of lost work
            recent = [s for s in self.timer.flagged
                      if s > step - self.timer.window]
            if (self.cfg.straggler_ckpt_after
                    and slow
                    and len(recent) >= self.cfg.straggler_ckpt_after):
                print(f"step {step}: {len(recent)} stragglers in window -> "
                      f"checkpoint-and-rebalance")
                self.save(step + 1)
                self.timer.flagged.clear()
            elif (step + 1) % self.cfg.ckpt_every == 0 or step + 1 == end:
                self.save(step + 1)
        return self.history
