"""Pinned selection primitives (port of ``repro.compressors.select``).

The selection contract: rank keys are ``f32(|u|)`` (:func:`rank_keys`), and
ties -- equal f32 keys, including f64 values that collide when rounded --
break toward the LOWEST packed index.  :func:`topk_indices` gets that order
from a stable descending sort (``torch.topk`` leaves the order of ties
unspecified, so it is not used); :func:`threshold_keep_mask` selects the same
set without a sort, by the formulation the TopK kernel runs.  Every function
takes any number of leading (batch) dimensions.
"""

from __future__ import annotations

import torch

RANK_DTYPE = torch.float32


def rank_keys(u: torch.Tensor) -> torch.Tensor:
    """The pinned selection keys: f32 magnitudes."""
    return torch.abs(u).to(RANK_DTYPE)


def topk_indices(u: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest keys, in descending key order, lowest index
    first among ties."""
    _, idx = torch.sort(rank_keys(u), dim=-1, descending=True, stable=True)
    return idx[..., :k]


def topk_dense(u: torch.Tensor, k: int) -> torch.Tensor:
    """Dense TopK sparsification C(u) by the sorted indices."""
    idx = topk_indices(u, k)
    return torch.zeros_like(u).scatter(-1, idx, torch.gather(u, -1, idx))


def threshold_keep_mask(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the same set as :func:`topk_indices`, without a sort.

    ``keys`` are the non-negative f32 :func:`rank_keys`; their int32 bit
    patterns order as their values, so the k-th largest key is found by a
    31-step binary search on the bits.  Keys above the threshold are kept;
    of the keys equal to it, the first ``k - n_gt`` in index order.
    """
    bits = keys.view(torch.int32)
    thr = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(31):
        cand = thr | (1 << (30 - i))
        hit = (bits >= cand[..., None]).sum(dim=-1) >= k
        thr = torch.where(hit, cand, thr)
    gt = bits > thr[..., None]
    eq = bits == thr[..., None]
    n_gt = gt.sum(dim=-1, keepdim=True)
    return gt | (eq & (torch.cumsum(eq, dim=-1) <= k - n_gt))


def topk_dense_masked(u: torch.Tensor, k: int) -> torch.Tensor:
    """Dense TopK via :func:`threshold_keep_mask`; the same output as
    :func:`topk_dense` (the same set, values are copies, zeros are +0.0)."""
    keep = threshold_keep_mask(rank_keys(u), k)
    return torch.where(keep, u, torch.zeros_like(u))
