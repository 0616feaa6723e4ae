"""Training and inference steps, AdamW, the synthetic token stream, EF21 and
checkpoints (port of ``repro.train``)."""

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.data import synthetic_batch, synthetic_token_stream
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import loss_for, make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "adamw_init",
    "adamw_update",
    "AdamWConfig",
    "make_train_step",
    "make_serve_step",
    "make_prefill_step",
    "loss_for",
    "synthetic_batch",
    "synthetic_token_stream",
    "save_checkpoint",
    "load_checkpoint",
]
