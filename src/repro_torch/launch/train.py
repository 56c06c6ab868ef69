"""Training launcher: ``--arch <id>`` selects an assigned architecture.

Two modes, as the reference's ``repro/launch/train.py``:

* ``--smoke`` — the arch's REDUCED config trained end to end on one
  device: the real data pipeline, optimizer and checkpoints
  (:func:`smoke_train`);
* default — the production posture: the full config's step on the
  production mesh through the dry run (``dryrun.run_cell``: its spec on a
  (16, 16) or, with ``--multi-pod``, a (2, 16, 16) mesh of meta entries,
  traced and counted; nothing is allocated and no card is needed).  The
  record is printed and returned.

The smoke run is on the card (``--device cuda``, the default; it raises
without one) unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 20 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
      [--shape train_4k] [--multi-pod]
"""

from __future__ import annotations

import argparse
import tempfile


def smoke_train(arch_name: str, steps: int, ckpt_dir: str | None,
                device="cuda"):
    """The arch's smoke config, ``DataConfig(seq_len=32, global_batch=8)``
    and ``AdamWConfig(lr=1e-3, warmup_steps=5)`` through the
    :class:`~repro_torch.train.loop.Trainer` for ``steps`` steps, weights
    drawn from a generator seeded 0 on ``device``.  Returns the trainer
    (its ``history`` holds the steps)."""
    import torch
    from ..configs import get_arch
    from ..data import DataConfig, ShardedTokenPipeline, SyntheticLMDataset
    from ..kernels import resolve_device
    from ..models.transformer import init_params
    from ..train.loop import Trainer, TrainConfig
    from ..train.optimizer import AdamWConfig

    arch = get_arch(arch_name)
    if arch.family != "lm":
        raise SystemExit(f"--smoke training supports LM archs; "
                         f"{arch_name} is {arch.family}")
    dev = resolve_device(device)
    cfg = arch.smoke_config
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"[smoke] {arch_name}: reduced config, {n/1e6:.2f}M params on "
          f"{dev}")
    dcfg = DataConfig(seq_len=32, global_batch=8, vocab=cfg.vocab)
    pipe = ShardedTokenPipeline(SyntheticLMDataset(dcfg))

    def loss_fn(m, batch):
        return m.lm_loss(batch["tokens"], batch["targets"])

    tr = Trainer(loss_fn, model, pipe,
                 opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5,
                                     total_steps=steps),
                 train_cfg=TrainConfig(
                     total_steps=steps, ckpt_every=max(steps // 2, 1),
                     ckpt_dir=ckpt_dir or tempfile.mkdtemp(prefix="smoke_"),
                     log_every=max(steps // 10, 1)))
    hist = tr.run()
    print(f"[smoke] final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    return tr


def production_compile(arch_name: str, shape: str, multi_pod: bool) -> dict:
    """The cell's dry-run record on the production mesh."""
    from .dryrun import run_cell
    return run_cell(arch_name, shape, multi_pod)


def main(argv=None):
    """The launcher; with ``--smoke`` returns the trainer, else the dry
    run's record."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if not args.smoke:
        return production_compile(args.arch, args.shape, args.multi_pod)
    return smoke_train(args.arch, args.steps, args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
