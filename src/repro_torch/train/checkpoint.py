"""Fault-tolerant checkpoint manager, in the reference's on-disk format, so
that a checkpoint written by either package restores into the other.

* **atomic** — written to ``step_<n>.tmp/`` and ``os.rename``d to
  ``step_<n>/``; the ``manifest.json`` with per-array SHA-256 hashes is
  written LAST, so a directory without a manifest is incomplete and
  ignored;
* **versioned** — ``latest()`` is the newest complete step; ``retain``
  old checkpoints are kept for rollback;
* **elastic** — arrays are saved whole, in the reference's logical
  layout (a model's layer leaves stacked ``(L, ...)``), and ``restore``
  puts them on an explicit ``device``, or cuts each into the shards of a
  mesh of any shape (``shardings``);
* **integrity** — every array's SHA-256 is checked on load;
* **exact data resume** — the pipeline cursor and the optimizer step are
  part of the payload.

The files are the reference's: ``arrays.npz`` keyed by the leaf paths with
``/`` → ``__`` (``params__layers__attn__wq``, ``opt__.mu__ln_f``), and a
dtype numpy lacks (bf16) stored as its raw bytes viewed as ``uint8``,
its logical dtype name in the manifest.  A bf16 tensor goes to disk as
``t.view(torch.uint8)`` and comes back through ``view(torch.bfloat16)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from ..distributed.sharding import Mesh, shard_tensor
from .tree import (Stacked, is_model, leaves_with_paths, map_with_paths,
                   parts, rebuild)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], Mesh)


def _to_storable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array stored, its logical dtype name).  A dtype numpy has no
    builtin for is stored as its raw bytes, viewed as uint8."""
    t = t.detach().cpu().contiguous()
    if t.dtype.is_floating_point and t.dtype not in (
            torch.float16, torch.float32, torch.float64):
        return t.view(torch.uint8).numpy(), str(t.dtype).split(".")[-1]
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, logical: str,
                   shape: tuple[int, ...]) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if arr.dtype == np.uint8 and logical != "uint8":
        t = t.view(getattr(torch, logical))
    return t.reshape(shape)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    retain: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any, extra: dict | None = None) -> str:
        """``state`` is any tree of tensors (a model among them); ``extra``
        is a JSON-able dict (pipeline cursor, config fingerprint, ...)."""
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        manifest: dict[str, Any] = {"step": int(step),
                                    "extra": extra or {}, "arrays": {}}
        payload = {}
        for path, leaf in leaves_with_paths(state):
            stored, logical = _to_storable(
                leaf.stack() if isinstance(leaf, Stacked) else leaf)
            key = path.replace("/", "__")
            payload[key] = stored
            manifest["arrays"][path] = {
                "key": key,
                "shape": list(leaf.shape),
                "dtype": logical,
                "sha256": _sha256(stored),
            }
        np.savez(os.path.join(tmp, "arrays.npz"), **payload)
        # manifest LAST: its presence marks the checkpoint complete
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    # -- read ----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "manifest.json"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, target: Any, device=None,
                verify: bool = True, shardings: Any = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``target`` (a tree of tensors, or
        of anything with ``shape`` and ``dtype``, such as tensors on the
        meta device).  Each array is cast to its target's dtype and put on
        ``device``, by default its target's (the CPU for a meta target).  A
        model in the target is filled in place, its parameters keeping
        their identity (``device`` moves it first).  Returns (state,
        extra).

        ``shardings`` (a tree matching ``target``, of ``(mesh, P)`` pairs;
        a model's part is the nested dict of its stacked tree) re-shards
        for the current mesh — elastic restore across mesh shapes: each
        array comes back as its per-coordinate shards
        (``shard_tensor``), each on its coordinate's device, and a model
        in the target as the nested dict of its leaves' shards."""
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dev = None if device is None else torch.device(device)
        cuts = None if shardings is None else dict(
            leaves_with_paths(shardings, is_leaf=_is_pair))

        with np.load(os.path.join(d, "arrays.npz")) as data:
            def load(path: str, leaf) -> torch.Tensor:
                meta = manifest["arrays"][path]
                raw = data[meta["key"]]
                if verify and _sha256(raw) != meta["sha256"]:
                    raise IOError(f"checkpoint corruption detected at {path}")
                arr = _from_storable(raw, meta["dtype"], tuple(meta["shape"]))
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{path}: saved {tuple(arr.shape)} != "
                                     f"target {tuple(leaf.shape)}")
                return arr.to(leaf.dtype)

            def cut(path: str, leaf) -> list[torch.Tensor]:
                mesh, spec = cuts[path]
                return shard_tensor(load(path, leaf), spec, mesh)

            def restore_node(path: str, node):
                if cuts is not None:
                    if not is_model(node):
                        return cut(path, node)
                    return rebuild(node, [cut(p, leaf) for p, leaf in
                                          leaves_with_paths(node, path)])
                if not is_model(node):
                    to = dev or node.device
                    return load(path, node).to(
                        "cpu" if to.type == "meta" else to)
                if dev is not None:
                    node.to(dev)
                with torch.no_grad():
                    for p, leaf in leaves_with_paths(node, path):
                        arr = load(p, leaf)
                        for t, a in zip(parts(leaf), arr if isinstance(
                                leaf, Stacked) else [arr]):
                            t.copy_(a)
                return node

            state = map_with_paths(restore_node, target)
        return state, manifest["extra"]

    # -- retention -------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.retain)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))
