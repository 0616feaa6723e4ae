"""Pinned selection primitives (port of ``repro.compressors.select``).

The selection contract: rank keys are ``f32(|u|)`` (:func:`rank_keys`), and
ties -- equal f32 keys, including f64 values that collide when rounded --
break toward the LOWEST packed index.  :func:`topk_indices` gets that order
from a stable descending sort (``torch.topk`` leaves the order of ties
unspecified, so it is not used); :func:`threshold_keep_mask` selects the same
set without a sort, by the formulation the TopK kernel runs.  Every function
takes any number of leading (batch) dimensions.

RandSeqK and TopLEK take their draws as tensors (the start ``s``, int64, and
the Bernoulli uniform ``unif``, float64, one per row), made outside from the
PRNG keys (:mod:`repro_torch.prng`), as the reference's kernels take theirs;
Natural takes one float64 uniform per entry (:func:`natural_from_uniform`).
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


def randseqk_window_mask(t: int, k: int, s: torch.Tensor) -> torch.Tensor:
    """Membership mask of each circular window {s, ..., s+k-1 mod T}:
    s (...,) int64 -> (..., T).  ``%`` on tensors takes the divisor's sign,
    as ``jnp``'s does, so any integer s gives a window in [0, T)."""
    pos = torch.arange(t, device=s.device)
    return (pos - s[..., None]) % t < k


def randseqk_dense(u: torch.Tensor, k: int, s: torch.Tensor) -> torch.Tensor:
    """Dense RandSeqK given the start draws ``s``: roll each row by -s, keep
    the first k, roll back (the paper's contiguous window, Appendix C)."""
    t = u.shape[-1]
    pos = torch.arange(t, device=u.device)
    rolled = torch.gather(u, -1, ((pos + s[..., None]) % t).expand_as(u))
    window = torch.where(pos < k, rolled, torch.zeros_like(rolled))
    return torch.gather(window, -1, ((pos - s[..., None]) % t).expand_as(u))


def randseqk_dense_masked(u: torch.Tensor, k: int, s: torch.Tensor) -> torch.Tensor:
    """Dense RandSeqK via :func:`randseqk_window_mask`; bit-identical to
    :func:`randseqk_dense` (values are copies, zeros are +0.0)."""
    return torch.where(randseqk_window_mask(u.shape[-1], k, s), u, torch.zeros_like(u))


def toplek_from_uniform(
    u: torch.Tensor, k: int, unif: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """TopLEK (paper Algorithm 4) given each row's Bernoulli uniform ``unif``.

    Target contraction delta = k/T.  alpha_m is the energy fraction of the
    top-m entries (in :func:`topk_indices` order); m* is the smallest m with
    alpha_m >= delta, at most k.  Keep m*-1 entries if unif < p with
    p = (alpha_m* - delta) / (alpha_m* - alpha_m*-1), else m*; keep none of
    an all-zero row.  Returns (u_hat, kept): kept (...,) int32.

    m* is ``1 + #{alpha < delta}``, which equals the reference's
    ``searchsorted(alphas, delta, side="left") + 1`` since alpha does not
    decrease.  The prefix sum is ``torch.cumsum``: its order (and the
    reference's) decides alpha's last bit, which can move kept by one only
    where alpha_m* lies within a few ulps of delta or unif of p.
    """
    t = u.shape[-1]
    delta = k / t
    idx = topk_indices(u, k)
    vals = torch.gather(u, -1, idx)
    csum = torch.cumsum(vals * vals, dim=-1)
    total = torch.sum(u * u, dim=-1, keepdim=True)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    alphas = csum / safe_total  # alphas[..., m-1] = alpha_m
    m_star = torch.clamp((alphas < delta).sum(-1, keepdim=True) + 1, max=k)
    alpha_hi = torch.gather(alphas, -1, m_star - 1)
    alpha_lo = torch.where(
        m_star > 1,
        torch.gather(alphas, -1, torch.clamp(m_star - 2, min=0)),
        torch.zeros_like(alpha_hi),
    )
    gap = alpha_hi - alpha_lo
    p = torch.where(gap > 0, (alpha_hi - delta) / torch.where(gap > 0, gap, 1.0), 0.0)
    p = torch.clamp(p, 0.0, 1.0)
    kept = torch.where(unif[..., None] < p, m_star - 1, m_star)
    kept = torch.where(total > 0, kept, torch.zeros_like(kept))
    keep = torch.arange(k, device=u.device) < kept
    u_hat = torch.zeros_like(u).scatter(-1, idx, torch.where(keep, vals, 0.0))
    return u_hat, kept[..., 0].to(torch.int32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0**e in float64 for integer e, exact, built from its bits: a normal
    number for -1022 <= e <= 1023, a subnormal for -1074 <= e < -1022, +inf
    above 1023 and 0.0 below -1074, the values ``jnp.ldexp(1.0, e)`` gives.
    Built from the bits, it is exact on every device whatever the exponent's
    type, where ``torch.ldexp(x, e)`` is ``x * torch.pow(2, e)`` and so
    rests on how ``pow`` rounds in the type it promotes to."""
    e = torch.clamp(e.to(torch.int64), -1075, 1024)
    normal = torch.clamp(e + 1023, min=0) << 52
    subnormal = torch.where(e >= -1074, 1 << torch.clamp(e + 1074, 0, 62), 0)
    return torch.where(e >= -1022, normal, subnormal).view(torch.float64)


def natural_from_uniform(u: torch.Tensor, unif: torch.Tensor, *, scaled: bool = True) -> torch.Tensor:
    """Natural compression (probabilistic rounding to a power of two) given
    one float64 uniform per entry, ``unif`` of u's shape: the reference's
    ``natural`` with ``bernoulli(key, p)`` lowered to ``unif < p``.

    |u| = mant * 2**e with mant in [0.5, 1); round up to 2**e where
    unif < 2 mant - 1, else down to 2**(e-1); keep the sign, +0.0 where
    u == 0, times 8/9 when ``scaled``.  Subnormal inputs and results (below
    2**-1022) follow IEEE here, as on the card; XLA on the CPU flushes them
    to zero, so there the reference differs from this below 2**-1022 only."""
    mant, exp = torch.frexp(torch.abs(u))
    p_up = 2.0 * mant - 1.0
    up = unif < torch.clamp(p_up, 0.0, 1.0)
    out = torch.where(u == 0, 0.0, torch.sign(u) * pow2(exp - 1 + up.to(exp.dtype)))
    return out * (8.0 / 9.0) if scaled else out
