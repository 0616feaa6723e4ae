"""Shared transformer building blocks (port of ``repro.models.layers``).

Plain functions on (B, S, ...) activations in bf16 compute with f32 params,
over explicit param dicts.  Attention never materialises (S, S) scores:
``chunked_attention`` sends CUDA tensors to the hand-written flash kernel
(``kernels/csrc/flash_attention.cu``) and runs CPU tensors through the
reference's query-chunked softmax, line for line.  The reference's mesh
plumbing (``constrain``, ``set_sharding_axes``, ``chunked_map``) is not here:
it waits with the TPU dry-run tooling (ROADMAP A.4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

COMPUTE_DTYPE = torch.bfloat16

_NEG = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (full or fractional -- chatglm applies RoPE to
# half the head dims: rope_fraction = 0.5)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, fraction: float = 1.0,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    d_rot = int(dh * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    half = d_rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]  # (S, half)
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = positions[..., None].float() * freqs  # (B, S, half)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kv, Dh) -> (B, S, Kv*n_rep, Dh) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(b, s, kv * n_rep, dh)


def window_slices(sq: int, sk: int, window: int, q_chunk: int) -> list[tuple[int, int, int, int]]:
    """The reference's sliding-window key slice of each query chunk:
    ``(q_start, q_len, k_start, span)`` with span = min(sk, window + q_chunk -
    1) and k_start = clip(q_start + q_chunk - span, 0, sk - span); q_chunk
    becomes sq where it does not divide sq."""
    if sq % q_chunk:
        q_chunk = sq
    span = min(sk, window + q_chunk - 1)
    return [(q_start, q_chunk, min(max(q_start + q_chunk - span, 0), sk - span), span)
            for q_start in range(0, sq, q_chunk)]


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Memory-bounded attention: q (B,Sq,H,Dh), k/v (B,Sk,Kv,Dh) -> (B,Sq,H,Dh).

    A CUDA tensor goes to the flash kernel, with no (Sq, Sk) matrix and no
    repeated kv heads.  A CPU tensor runs the reference's computation:
    queries in chunks of q_chunk, GQA by repeating kv heads, and for a
    sliding window the keys of each chunk sliced to
    :func:`window_slices`' ``[k_start, k_start + span)``.

    On the card, every mask but a window without causality is one launch
    over all keys, ``q_chunk`` unused: there the slice drops no visible key.
    A window without causality is one launch per query chunk, on the
    chunk's key slice, with the chunk's and the slice's positions passed to
    the kernel (``q_offset``, ``k_offset``) so that its window mask reads
    absolute positions: the reference's function, whose slice drops the
    keys after the chunk (but where the clip at 0 widens the first chunks'
    slice).  The two compute one function wherever some key is visible to
    every query; where none is, the kernel writes 0 and the chunked softmax
    averages all keys.
    """
    if q.is_cuda:
        if window is None or causal:
            return ops.attention(q, k, v, causal=causal, window=window)
        return window_chunk_attention(q, k, v, window, q_chunk)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = dh**-0.5
    kf = _repeat_kv(k, n_rep)
    vf = _repeat_kv(v, n_rep)

    if sq % q_chunk:
        q_chunk = sq  # fall back to a single chunk for odd lengths
    n_chunks = sq // q_chunk
    # only the last (window + q_chunk - 1) keys can be visible
    slices = window_slices(sq, sk, window, q_chunk) if window is not None else None

    kpos_all = torch.arange(sk, device=q.device)

    def one_chunk(ci: int) -> torch.Tensor:
        q_start = ci * q_chunk
        qc = q[:, q_start : q_start + q_chunk]
        qpos = q_start + torch.arange(q_chunk, device=q.device)
        if window is not None:
            _, _, k_start, span = slices[ci]
            kc = kf[:, k_start : k_start + span]
            vc = vf[:, k_start : k_start + span]
            kpos = k_start + torch.arange(span, device=q.device)
        else:
            kc, vc, kpos = kf, vf, kpos_all
        logits = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
        mask = torch.ones((q_chunk, kpos.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask[None, None], logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vc.float()).to(q.dtype)

    return torch.cat([one_chunk(ci) for ci in range(n_chunks)], dim=1)


def window_chunk_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, q_chunk: int
) -> torch.Tensor:
    """A window without causality, as the reference's chunks compute it:
    ``ops.attention`` once per query chunk on its key slice
    (:func:`window_slices`), the offsets telling the kernel where both lie.
    On a CUDA tensor each chunk is one flash launch; on the CPU the kernel's
    plain version."""
    parts = []
    for q_start, q_len, k_start, span in window_slices(q.shape[1], k.shape[1], window, q_chunk):
        parts.append(ops.attention(
            q[:, q_start:q_start + q_len].contiguous(),
            k[:, k_start:k_start + span].contiguous(),
            v[:, k_start:k_start + span].contiguous(),
            causal=False, window=window, q_offset=q_start, k_offset=k_start))
    return torch.cat(parts, dim=1)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S_cache, Kv, Dh)
    v_cache: torch.Tensor,
    cur_len: int,  # number of valid cache entries
    *,
    ring: bool = False,  # True when the cache is a sliding-window ring buffer
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    Plain PyTorch on every device, as the reference's einsum: decoding runs
    no kernel."""
    b, _, h, dh = q.shape
    s_cache, kv = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kv
    kf = _repeat_kv(k_cache, n_rep)
    vf = _repeat_kv(v_cache, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * dh**-0.5
    n_valid = min(cur_len, s_cache) if ring else cur_len  # a wrapped ring is all valid
    valid = torch.arange(s_cache, device=q.device) < n_valid
    logits = torch.where(valid[None, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_apply(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """x: (B, S, D).  p: {"w1": (D,F), "w2": (F,D)[, "w1g": (D,F)]}."""
    w1 = p["w1"].to(x.dtype)
    w2 = p["w2"].to(x.dtype)
    if activation == "silu_glu":
        g = x @ p["w1g"].to(x.dtype)
        h = F.silu(x @ w1) * g
    elif activation == "sq_relu":  # nemotron: squared ReLU
        h = torch.square(F.relu(x @ w1))
    elif activation == "gelu":  # jax.nn.gelu's default is the tanh form
        h = F.gelu(x @ w1, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ w2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (negative labels are masked)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
