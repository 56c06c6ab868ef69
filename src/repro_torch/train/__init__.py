"""The training tier of the port: AdamW (``optimizer``), atomic versioned
checkpoints in the reference's format (``checkpoint``) and the
fault-tolerant loop (``loop``), over trees walked as the reference's
pytrees (``tree``)."""

from .checkpoint import CheckpointManager
from .loop import StepTimer, Trainer, TrainConfig, make_train_step
from .optimizer import (AdamWConfig, OptState, adamw_update,
                        clip_by_global_norm, compress_int8, decompress_int8,
                        init_opt_state, lr_at)

__all__ = [
    "AdamWConfig", "CheckpointManager", "OptState", "StepTimer", "Trainer",
    "TrainConfig", "adamw_update", "clip_by_global_norm", "compress_int8",
    "decompress_int8", "init_opt_state", "lr_at", "make_train_step",
]
