"""Dense oracle of the flash-attention kernel (port of ``repro.kernels.ref``).

The (Sq, Sk) logits are materialised, so it is for small tests only; the
kernel's plain version (``kernels/flash_attention.py:flash_attention_plain``)
is the chunked form of the same function.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Dense attention reference.  q, k, v: (seq, heads, head_dim), one batch row.

    window: sliding-window size W -- query t attends to keys in
    [t - W + 1, t] (combined with causality).  None = full causal/bidirectional.
    """
    sq, _, dh = q.shape
    sk = k.shape[0]
    s = 1.0 / math.sqrt(dh) if scale is None else scale
    logits = torch.einsum("qhd,khd->hqk", q, k) * s
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[None], -math.inf)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    return torch.einsum("hqk,khd->qhd", p, v)
