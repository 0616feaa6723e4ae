"""EF21-style compressed gradient aggregation for the LM training loop (port
of ``repro.train.grad_compress``).

TopK on each flattened leaf as a first-order gradient compressor with
error feedback (Richtárik et al., EF21): the estimator update
g <- g + C(grad - g) is FedNL's Hessian-learning rule applied to gradients.
As in the reference, the compression is modelled on the averaged gradient.
"""

from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_map


def ef21_init(params):
    return tree_map(torch.zeros_like, params)


def _topk_leaf(delta: torch.Tensor, frac: float) -> torch.Tensor:
    """delta with all but its k = max(1, int(frac n)) largest |entries| (in
    f32) zeroed: ``lax.top_k``'s set, ties kept lowest index first (a
    stable descending sort; ``lax.top_k`` is not a Pallas kernel)."""
    flat = delta.reshape(-1)
    k = max(1, int(frac * flat.numel()))
    idx = torch.sort(flat.abs().float(), descending=True, stable=True).indices[:k]
    comp = torch.zeros_like(flat)
    comp[idx] = flat[idx]
    return comp.reshape(delta.shape)


def ef21_step(grads, est, frac: float):
    """Returns (new_estimator, grads_to_apply).  grads_to_apply == estimator."""
    new_est = tree_map(lambda g, e: e + _topk_leaf(g - e, frac), grads, est)
    return new_est, new_est
