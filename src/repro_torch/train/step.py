"""prefill_step / serve_step builders (port of the inference half of
``repro.train.step``).

`make_prefill_step(cfg)` returns (params, batch) -> last-position logits
(B, Vp); `make_serve_step(cfg)` returns (params, cache, tokens) ->
(logits, cache), one token with a KV cache.  The train step, ``loss_for``
and AdamW are ROADMAP A14, as is every encdec branch.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import check_ported, lm_decode_step, lm_prefill


def make_prefill_step(cfg: ArchConfig):
    check_ported(cfg)

    def prefill_step(params, batch):
        return lm_prefill(params, cfg, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, tokens) -> (logits, cache), one token per row.

    Unlike the reference's pure step, this one writes the new keys and
    values into the caller's cache tensors in place (the returned cache
    shares them and carries ``pos + 1``): static buffers are what a CUDA
    graph of the step needs.  So a cache must not be stepped twice from the
    same state (a retry, a beam): copy its tensors first.  A step past the
    cache's last slot raises ``IndexError``, where the reference clamps the
    write to the last slot."""
    check_ported(cfg)

    def serve_step(params, cache, tokens):
        return lm_decode_step(params, cfg, cache, tokens)

    return serve_step
