"""Mamba2 / SSD (state-space duality) mixer (port of ``repro.models.ssm``).

The reference's chunked SSD algorithm: the sequence is split into chunks of
length Q, the quadratic "attention-like" part runs within chunks, and a scan
over the chunks' summary states carries information across them.  Decoding
is the O(1)-state recurrence h' = exp(dt*A) h + dt * B (x) C.  Single SSM
group (B, C shared across heads), scalar-per-head A.

The reference's ``lax.scan`` over chunks is a Python loop over them.  The
state's contribution ``y_inter`` contracts the state axis n in its first
product, so no (chunks, Q, heads, head_dim, n) tensor is built (21.5 G
elements at mamba2's 32k prefill).  The f32 products stay f32: on the card
they need ``torch.backends.cuda.matmul.allow_tf32`` off (the default), since
TF32 would compute another function, and ``ssd_apply`` raises otherwise.
Decoding writes the new conv and SSM state into the caller's tensors in
place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def check_f32_matmul(x: torch.Tensor) -> None:
    """Raise where an f32 product on x's device would run in TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the SSD and RG-LRU f32 "
            "products would run in TF32 and compute another function")


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C), w: (cw, C), b: (C,).  The
    window's products are summed in f32 and rounded to x's type once, then
    the bias is added in x's type (the reference's einsum, then + b)."""
    cw, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    wf = w.to(x.dtype).float()
    acc = xp[:, 0:s].float() * wf[0]
    for i in range(1, cw):
        acc = acc + xp[:, i : i + s].float() * wf[i]
    return acc.to(x.dtype) + b.to(x.dtype)


def conv_step(conv_state: torch.Tensor, x_tok: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One token of ``causal_conv``: conv_state (B, cw-1, C) holds the
    previous inputs and is shifted in place to end with x_tok (B, 1, C);
    returns the conv output (B, C) before the activation."""
    window = torch.cat([conv_state, x_tok], dim=1)  # (B, cw, C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.to(window.dtype).float())
    conv_state.copy_(window[:, 1:])
    return out.to(window.dtype) + b.to(window.dtype)


def ssd_apply(x_res: torch.Tensor, p: dict, *, d_state: int, head_dim: int,
              expand: int, chunk: int, norm_eps: float = 1e-6) -> torch.Tensor:
    """Full-sequence SSD mixer.  x_res: (B, S, D) block input (post-norm)."""
    check_f32_matmul(x_res)
    bsz, s, d_model = x_res.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    n = d_state

    proj = x_res @ p["in_proj"].to(x_res.dtype)  # (B, S, 2*di + 2N + H)
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * n, n_heads], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x_in, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, S, H)
    a = -torch.exp(p["A_log"].float())  # (H,) negative
    da = dt * a  # (B, S, H) log-decay per step

    q = chunk if s % chunk == 0 else s
    nc = s // q
    xh = x_in.reshape(bsz, nc, q, n_heads, head_dim).float()
    bh = b_in.reshape(bsz, nc, q, n).float()
    ch = c_in.reshape(bsz, nc, q, n).float()
    dtc = dt.reshape(bsz, nc, q, n_heads)
    ca = torch.cumsum(da.reshape(bsz, nc, q, n_heads), dim=2)  # inclusive log decay
    xw = xh * dtc[..., None]  # dt-weighted inputs

    # intra-chunk (quadratic within the chunk); the upper triangle's decay is
    # exp(-inf) = 0 instead of the reference's masked exp of a positive sum
    g = torch.einsum("bcin,bcjn->bcij", ch, bh)  # (B, nc, Q, Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x_res.device))
    diff = ca[:, :, :, None, :] - ca[:, :, None, :, :]  # (B, nc, Q, Q, H)
    att = g[..., None] * torch.exp(diff.masked_fill_(~tri[:, :, None], float("-inf")))
    del diff
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xw)
    del att

    # chunk summary states and the scan over chunks
    decay_to_end = torch.exp(ca[:, :, -1:, :] - ca)  # (B, nc, Q, H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bh, xw * decay_to_end[..., None])
    chunk_decay = torch.exp(ca[:, :, -1, :])  # (B, nc, H)
    h_in = torch.empty_like(s_chunk)  # the state entering each chunk
    h_state = torch.zeros_like(s_chunk[:, 0])
    for c in range(nc):
        h_in[:, c] = h_state
        h_state = h_state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]

    # "bcin,bchpn,bcih->bcihp" with n summed out first
    y_inter = torch.einsum("bcin,bchpn->bcihp", ch, h_in) * torch.exp(ca)[..., None]

    y = y_intra + y_inter + p["D"].float()[None, None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner).to(x_res.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["gate_norm"], eps=norm_eps)
    return y @ p["out_proj"].to(x_res.dtype)


def ssd_decode_step(x_tok: torch.Tensor, state: dict, p: dict, *, d_state: int,
                    head_dim: int, expand: int, norm_eps: float = 1e-6):
    """One-token recurrence.  x_tok: (B, 1, D); state: {conv: (B, cw-1, C),
    ssm: (B, H, P, N)}, both updated in place.  Returns (out, state)."""
    check_f32_matmul(x_tok)
    bsz, _, d_model = x_tok.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    n = d_state

    proj = x_tok @ p["in_proj"].to(x_tok.dtype)
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * n, n_heads], dim=-1)
    xbc_t = F.silu(conv_step(state["conv"], xbc, p["conv_w"], p["conv_b"]))  # (B, C)
    x_in, b_in, c_in = torch.split(xbc_t, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]  # (B, H)
    dec = torch.exp(dt * -torch.exp(p["A_log"].float()))  # (B, H)
    xh = x_in.reshape(bsz, n_heads, head_dim).float()
    bh, ch = b_in.float(), c_in.float()  # (B, N)
    xw = xh * dt[..., None]

    ssm = state["ssm"]
    ssm.copy_(ssm * dec[..., None, None] + torch.einsum("bhp,bn->bhpn", xw, bh))
    y = torch.einsum("bn,bhpn->bhp", ch, ssm) + p["D"].float()[None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x_tok.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["gate_norm"], eps=norm_eps)
    return y @ p["out_proj"].to(x_tok.dtype), state
