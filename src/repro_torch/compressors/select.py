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


def blocked_cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order of XLA's CPU
    ``cumsum`` (``jnp.cumsum`` lowers to a full-window ``reduce_window``,
    which XLA rewrites into this recursive blocked scan): up to ``block``
    entries, one sequential sum; beyond, pad with zeros to a multiple of
    ``block``, sum sequentially inside each block, scan the block totals by
    the same rule, and add each block's exclusive prefix to its entries."""
    n = x.shape[-1]
    if n <= block:
        out = x.clone()
        for j in range(1, n):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out
    n_blocks = -(-n // block)
    padded = torch.nn.functional.pad(x, (0, n_blocks * block - n))
    blocks = padded.reshape(*x.shape[:-1], n_blocks, block).clone()
    for j in range(1, block):
        blocks[..., j] = blocks[..., j - 1] + blocks[..., j]
    carried = blocked_cumsum(blocks[..., -1], block)
    before = torch.nn.functional.pad(carried[..., :-1], (1, 0))  # exclusive prefix
    return (blocks + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def windowed_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU reduction (the
    reference's ``jnp.sum``): while more than ``window`` entries remain, pad
    with zeros to a multiple of ``window`` (half the padding before, the
    rest after) and replace each window by its sequential sum; then one
    sequential sum of what remains."""
    while x.shape[-1] > window:
        n = x.shape[-1]
        pad = -(-n // window) * window - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, window)
        acc = x[..., 0]
        for j in range(1, window):
            acc = acc + x[..., j]
        x = acc
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


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
    decrease.  The order of the sums decides alpha's last bit, and with it
    kept wherever alpha_m* lies within a few ulps of delta (at k = T, where
    delta = 1, on most rows): the prefix sum is :func:`blocked_cumsum` and
    the total :func:`windowed_sum`, the orders in which XLA on the CPU
    computes the reference's ``jnp.cumsum`` and ``jnp.sum``.
    """
    idx, kept = toplek_kept_prefix(u, k, unif)
    return kept_prefix_dense(u, idx, kept), kept


def kept_prefix_dense(u: torch.Tensor, idx: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """u on the first ``kept`` indices of each row of ``idx``, +0.0 elsewhere."""
    keep = torch.arange(idx.shape[-1], device=u.device) < kept[..., None]
    vals = torch.gather(u, -1, idx)
    return torch.zeros_like(u).scatter(-1, idx, torch.where(keep, vals, 0.0))


def toplek_kept_prefix(
    u: torch.Tensor, k: int, unif: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """TopLEK's selection: the :func:`topk_indices` order (..., k), int64,
    and the kept count (...,), int32; the first ``kept`` of the order are
    kept (see :func:`toplek_from_uniform`)."""
    t = u.shape[-1]
    delta = k / t
    idx = topk_indices(u, k)
    vals = torch.gather(u, -1, idx)
    csum = blocked_cumsum(vals * vals)
    total = windowed_sum(u * u)[..., None]
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
    return idx, kept[..., 0].to(torch.int32)


def in_index_order(idx: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """The first ``kept`` entries of each row of ``idx`` (..., k) sorted by
    index, zeros after them: int32, the index forms' layout."""
    first = torch.arange(idx.shape[-1], device=idx.device) < kept[..., None]
    big = torch.iinfo(torch.int64).max
    ordered = torch.sort(torch.where(first, idx.to(torch.int64), big), dim=-1).values
    return torch.where(first, ordered, 0).to(torch.int32)


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
