"""LM serving engine: continuous-batching decode over a stacked KV cache.

The cache layout is (L, B, S_cache, ...) — one buffer slot per batch lane.
A lane is a *sequence slot*: when a sequence finishes (EOS / max_len) its
lane is immediately refilled from the waiting queue (continuous batching —
the serving-throughput trick of vLLM/Orca, with static shapes: the batch
is fixed at ``max_batch``, occupancy is a boolean mask).

Positions are per-lane, so lanes decode at different depths concurrently;
the attention mask in ``gqa_decode`` / ``mla_decode`` validates only
entries ``<= position``.  For the ``long_500k`` shape the cache is a ring
buffer of ``window`` slots (sliding-window attention) — position wraps
modulo the window, the Mistral recipe.

Every step runs under ``torch.inference_mode()`` on the model's device:
``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import resolve_device
from ..models.transformer import Transformer


@dataclasses.dataclass
class ServeConfig:
    max_batch: int
    s_cache: int
    max_new_tokens: int = 64
    eos_id: int = 1


class DecodeEngine:
    """Continuous batching over ``model`` (a
    :class:`~repro_torch.models.transformer.Transformer` that must already
    live on ``device``): ``submit`` prompts, then ``tick`` or
    ``run_until_drained``; finished sequences land in ``finished`` in the
    order they retire."""

    def __init__(self, model: Transformer, serve_cfg: ServeConfig,
                 device="cuda"):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, not on "
                             f"{dev}; move it with model.to({str(dev)!r})")
        self.model = model
        self.cfg = model.cfg
        self.scfg = serve_cfg
        self.device = dev
        B = serve_cfg.max_batch
        with torch.inference_mode():
            self.cache = model.init_cache(B, serve_cfg.s_cache)
        self.positions = np.zeros(B, dtype=np.int32)
        self.live = np.zeros(B, dtype=bool)
        self.tokens = np.zeros(B, dtype=np.int32)
        self.outputs: list[list[int]] = [[] for _ in range(B)]
        self.queue: list[np.ndarray] = []          # waiting prompts
        self.finished: list[list[int]] = []

    # -- request management ------------------------------------------------------

    def submit(self, prompt) -> None:
        self.queue.append(np.asarray(prompt, dtype=np.int32))

    def _admit(self) -> None:
        """Fill free lanes from the queue (continuous batching)."""
        for lane in np.nonzero(~self.live)[0]:
            if not self.queue:
                break
            prompt = self.queue.pop(0)
            # single-sequence prefill into the lane
            logits, cache = self.model.prefill(
                torch.from_numpy(prompt)[None, :])
            nxt = int(torch.argmax(logits[0]))
            S = prompt.shape[0]
            for name, buf in self.cache.items():
                # buf (L, B, S_cache, ...), cache[name] (L, 1, S, ...)
                buf[:, lane, :S] = cache[name][:, 0]
            self.positions[lane] = S
            self.tokens[lane] = nxt
            self.outputs[lane] = [nxt]
            self.live[lane] = True

    # -- one decode tick -----------------------------------------------------------

    @torch.inference_mode()
    def tick(self) -> int:
        """Admit + one batched decode step.  Returns #live lanes."""
        self._admit()
        if not self.live.any():
            return 0
        logits, self.cache = self.model.decode_step(
            torch.from_numpy(self.tokens.copy()), self.cache,
            torch.from_numpy(self.positions.copy()))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for lane in np.nonzero(self.live)[0]:
            tok = int(nxt[lane])
            self.outputs[lane].append(tok)
            self.positions[lane] += 1
            self.tokens[lane] = tok
            done = (tok == self.scfg.eos_id
                    or len(self.outputs[lane]) >= self.scfg.max_new_tokens
                    or self.positions[lane] >= self.scfg.s_cache)
            if done:
                self.finished.append(self.outputs[lane])
                self.outputs[lane] = []
                self.live[lane] = False
        return int(self.live.sum())

    def run_until_drained(self, max_ticks: int = 10_000) -> list[list[int]]:
        for _ in range(max_ticks):
            n = self.tick()
            if n == 0 and not self.queue:
                break
        return self.finished
