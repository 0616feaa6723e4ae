"""Flat-npz pytree checkpointing (port of ``repro.train.checkpoint``).

Pytrees are flattened with '/'-joined key paths into one ``.npz``, the same
format as the reference's, so a checkpoint written by either package loads in
the other.  Restore rebuilds against a reference pytree of tensors (shape
checked; dtype and device taken from it).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        t = torch.as_tensor(tree).detach().cpu()
        # numpy has no bfloat16: widen to f32, which is exact and loads back
        out[prefix[:-1]] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def save_checkpoint(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_checkpoint(path: str, like):
    """Restore into the structure of `like` (a pytree of tensors)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:

        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            key = prefix[:-1]
            arr = data[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(
                    f"checkpoint mismatch at {key}: {arr.shape} vs {tuple(tree.shape)}"
                )
            return torch.as_tensor(arr).to(dtype=tree.dtype, device=tree.device)

        return rebuild(like)
