"""train_step / prefill_step / serve_step builders for every architecture
family (port of ``repro.train.step``).

`make_train_step(cfg)` returns (params, opt_state, batch) -> (params,
opt_state, {"loss", "grad_norm"}): the loss and its gradient over
``cfg.accum_steps`` microbatches (the global batch (B, ...) split into
(A, B/A, ...) in order), the grads added in f32 in microbatch order and the
loss and grads divided by A, then one AdamW update (``train.optimizer``,
which updates params, m and v in place).  A param that the loss does not
reach (a hybrid model's untaken branch) gets a zero gradient, as
``jax.value_and_grad`` gives it, so AdamW's weight decay still moves it.
The batch may hold numpy arrays (``train.data``) or tensors; they are moved
to the params' device.  On a mesh (DTensor params, ``launch.train --mesh``)
the batch must already be DTensors on it; each gradient is reduced to its
param's placements before the update (a partial sum over the data axis
becomes the param's layout) and the loss is replicated.

`make_prefill_step(cfg)` returns (params, batch) -> last-position logits
(B, Vp): the batch holds ``tokens``, and ``src_embeds`` for encdec and
optionally ``img_embeds`` for vlm.  `make_serve_step(cfg)` returns
(params, cache, tokens) -> (logits, cache), one token with a KV/state cache.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import is_dtensor
from repro_torch.models.encdec import encdec_decode_step, encdec_loss, encdec_prefill
from repro_torch.models.lm import lm_decode_step, lm_loss, lm_prefill
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map


def loss_for(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return lambda params, batch: encdec_loss(params, cfg, batch)
    return lambda params, batch: lm_loss(params, cfg, batch)


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """The batch's rows in ``accum`` consecutive microbatches.  Where a
    mesh splits the batch over data, microbatch i is rows i, i + accum, i
    + 2 accum, ...: each rank's rows of it are its own; the step's
    gradient sums the same rows."""
    def split(x):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        if is_dtensor(x) and x.to_local().shape[0] != b:  # the batch is split over data
            return x.reshape(b // accum, accum, *x.shape[1:]).transpose(0, 1)
        return x.reshape(accum, b // accum, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def batch_to(batch: dict, device: torch.device) -> dict:
    """A batch's arrays as tensors on ``device``: tokens and labels int64,
    embeddings as they are (f32)."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(val, device=device)
        out[key] = t.long() if key in ("tokens", "labels") else t
    return out


def value_and_grad(loss_fn: Callable, params, microbatches) -> tuple[torch.Tensor, dict]:
    """The summed loss of ``microbatches`` and its gradient with respect to
    every leaf of ``params``: each microbatch's backward adds into the
    gradients in f32, in order; a leaf the loss does not reach gets zeros,
    as ``jax.value_and_grad`` gives it.  The params are not changed."""
    # the params' storage, as autograd leaves of this call only
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = None
    for mb in microbatches:
        mb_loss = loss_fn(live, mb)
        mb_loss.backward()
        mb_loss = _laid_out_as(mb_loss.detach(), None)
        loss = mb_loss if loss is None else loss + mb_loss
    grads = tree_map(lambda p, leaf: torch.zeros_like(p) if leaf.grad is None
                     else _laid_out_as(leaf.grad, p), params, live)
    return loss, grads


def _laid_out_as(t: torch.Tensor, like: torch.Tensor | None) -> torch.Tensor:
    """A DTensor ``t`` redistributed to ``like``'s placements (replicated
    where ``like`` is None); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    want = tuple(like.placements) if like is not None else tuple(
        Replicate() for _ in range(t.device_mesh.ndim))
    return t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): one step over ``cfg.accum_steps`` microbatches.

    Unlike the reference's pure step, this one writes the new params and
    AdamW's m and v into the caller's tensors in place, and returns those
    same tensors (the step count is a new tensor): one copy of the f32
    state is what lets a full-width step fit one card.  So a state must not
    be stepped twice from the same values (a retry, a comparison of two
    learning rates): copy its tensors first."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = loss_for(cfg)
    accum = max(1, cfg.accum_steps)

    def train_step(params, opt_state, batch):
        if not is_dtensor(tree_leaves(params)[0]):
            batch = batch_to(batch, tree_leaves(params)[0].device)
        micro = _split_microbatches(batch, accum) if accum > 1 else [batch]
        loss, grads = value_and_grad(loss_fn, params, micro)
        if accum > 1:
            loss = loss / accum
            for g in tree_leaves(grads):
                g.div_(accum)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


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
