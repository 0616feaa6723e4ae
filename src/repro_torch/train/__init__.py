"""The inference half of ``repro.train``: the prefill and serve steps and
checkpoints.  Training (the train step, AdamW, data) is ROADMAP A14."""

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step", "save_checkpoint", "load_checkpoint"]
