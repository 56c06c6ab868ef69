"""End-to-end training driver: a ~100M-parameter decoder LM trained for a
few hundred steps with the full substrate — sharded data pipeline,
AdamW, atomic checkpointing, crash-exact resume, straggler telemetry; the
port's counterpart of ``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_lm           # demo
  PYTHONPATH=src python -m repro_torch.launch.train_lm --full --steps 300

The --full config is a 12-layer d=768 GQA model (~104M params, GPT-2-small
scale); the demo config (~8M params) runs the same code path.  The run is
on the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..data import DataConfig, ShardedTokenPipeline, SyntheticLMDataset
from ..kernels import resolve_device
from ..models.transformer import LMConfig, init_params
from ..train.loop import Trainer, TrainConfig
from ..train.optimizer import AdamWConfig

FULL = LMConfig(  # ~104M params
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv=4,
    d_ff=2048, vocab=32768, head_dim=64, vocab_pad_to=256, kv_chunk=256)

DEMO = LMConfig(  # ~8M params: same code path, minutes on CPU
    name="lm-demo", n_layers=4, d_model=256, n_heads=4, n_kv=2,
    d_ff=683, vocab=4096, head_dim=64, vocab_pad_to=256, kv_chunk=128)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = FULL if args.full else DEMO
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model} on {dev}")

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab)
    pipe = ShardedTokenPipeline(SyntheticLMDataset(dcfg))

    def loss_fn(m, batch):
        return m.lm_loss(batch["tokens"], batch["targets"])

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_")
    tr = Trainer(
        loss_fn, model, pipe,
        opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=20,
                            total_steps=args.steps),
        train_cfg=TrainConfig(total_steps=args.steps, ckpt_every=50,
                              ckpt_dir=ckpt_dir, log_every=10))
    print(f"checkpoints -> {ckpt_dir} (atomic, versioned; restart with "
          f"--ckpt-dir to resume exactly)")
    hist = tr.run()

    first = float(np.mean([h["loss"] for h in hist[:10]]))
    last = float(np.mean([h["loss"] for h in hist[-10:]]))
    toks = args.steps * args.batch * args.seq
    mean_t = float(np.median([h["time_s"] for h in hist[5:]]))
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({toks/1e6:.2f}M tokens)")
    print(f"median step {mean_t*1e3:.0f} ms "
          f"({args.batch*args.seq/mean_t:.0f} tok/s on {dev}); "
          f"stragglers flagged: {len(tr.timer.flagged)}")
    if not last < first:
        raise SystemExit("train_lm: the loss did not decrease")
    print("train_lm OK")
    return hist


if __name__ == "__main__":
    main()
