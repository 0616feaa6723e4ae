"""prefill_step / serve_step builders for every architecture family (port of
the inference half of ``repro.train.step``).

`make_prefill_step(cfg)` returns (params, batch) -> last-position logits
(B, Vp): the batch holds ``tokens``, and ``src_embeds`` for encdec and
optionally ``img_embeds`` for vlm.  `make_serve_step(cfg)` returns
(params, cache, tokens) -> (logits, cache), one token with a KV/state cache.
The train step, ``loss_for`` and AdamW are ROADMAP A14.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import encdec_decode_step, encdec_prefill
from repro_torch.models.lm import lm_decode_step, lm_prefill


def make_prefill_step(cfg: ArchConfig):
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return encdec_prefill(params, cfg, batch["src_embeds"], batch["tokens"])
    elif cfg.family == "vlm":
        def prefill_step(params, batch):
            return lm_prefill(params, cfg, batch["tokens"], batch.get("img_embeds"))
    else:
        def prefill_step(params, batch):
            return lm_prefill(params, cfg, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, tokens) -> (logits, cache), one token per row.

    Unlike the reference's pure step, this one writes the new state into the
    caller's cache tensors in place: the keys and values, and the ssm and
    hybrid families' conv and recurrent state (the returned cache shares
    them and carries ``pos + 1``): static buffers are what a CUDA graph of
    the step needs.  So a cache must not be stepped twice from the same
    state (a retry, a beam): copy its tensors first.  A step past the KV
    cache's last slot writes the last slot and attends to every slot, as
    the reference's clamped write does."""
    step = encdec_decode_step if cfg.family == "encdec" else lm_decode_step

    def serve_step(params, cache, tokens):
        return step(params, cfg, cache, tokens)

    return serve_step
