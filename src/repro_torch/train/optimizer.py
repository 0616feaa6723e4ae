"""AdamW on nested dicts of tensors (port of ``repro.train.optimizer``).

The reference's update is pure; this one writes the new params, m and v
into the tensors it is given and returns them in new dicts, so that a step
at granite-3-2b's full width holds one copy of the f32 params, m and v (3 x
10.14 GB) and not two.  A caller that wants the old state copies it first.
Every operation is the reference's, in f32: the step count is int32, the
bias corrections f32 powers, the global norm the square root of the
leaves' f32 sums of squares added in ``jax.tree.leaves`` order (sorted
keys), and the returned ``gnorm`` is the norm before clipping.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.layers import like


# C12: a leaf's update runs in slices of at most this many elements along
# its first dimension, so that its elementwise temporaries stay small: whole,
# they came to ~3 copies of the largest leaf (nemotron-4-15b's 256k-row
# embedding and head, 6.3 GB each in f32), past a card's 80 GB beside its
# 2-layer params, grads, m and v.  Elementwise, so the same bits either way.
UPDATE_SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order: keys sorted
    at every level."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` on the leaves of ``tree`` and the matching leaves of ``rest``,
    as a nested dict of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest)) for key, val in tree.items()}
    return fn(tree, *rest)


def adamw_init(params) -> dict:
    """Zero m and v like the params, and step 0 (int32, on the params'
    device)."""
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def opt_state_from_numpy(tree, device: str | torch.device | None = None) -> dict:
    """A reference optimizer state (m, v and step, as numpy) as tensors on
    ``device`` (None: the card), the same nesting and dtypes."""
    from repro_torch.models.lm import params_from_numpy

    return {"m": params_from_numpy(tree["m"], device), "v": params_from_numpy(tree["v"], device),
            "step": params_from_numpy(np.asarray(tree["step"], dtype=np.int32), device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted keys) of sum(g_f32 ** 2), the
    leaves' sums added in order in f32."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(g.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step -> (params, opt_state, gnorm), params, m and v updated
    in place (see the module docstring) and the grads scaled in place by the
    clip factor."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    b1 = like(step, torch.tensor(cfg.b1, dtype=torch.float32, device=step.device))
    b2 = like(step, torch.tensor(cfg.b2, dtype=torch.float32, device=step.device))
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def update_slice(p, g, m, v):
        g.mul_(scale)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)  # the reference's (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        p.sub_(cfg.lr * u)

    def update(p, g, m, v):
        # a plain tensor's rows in slices (views: written in place); a
        # DTensor's whole, its slicing being a redistribution
        if type(p) is not torch.Tensor or p.dim() == 0 or p.numel() <= UPDATE_SLICE_ELEMS:
            update_slice(p, g, m, v)
            return p
        rows = max(1, UPDATE_SLICE_ELEMS // (p.numel() // p.shape[0]))
        for lo in range(0, p.shape[0], rows):
            update_slice(*(t[lo : lo + rows] for t in (p, g, m, v)))
        return p

    new_params = tree_map(update, params, grads, opt_state["m"], opt_state["v"])
    return new_params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, gnorm
