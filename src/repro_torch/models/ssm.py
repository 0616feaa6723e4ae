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

On a mesh (DTensors) the mixer between the input projection and the gate
norm runs on each rank's shards (``layers.on_shards``): the projection is
gathered over tp and each rank takes its own heads (x, z, dt and their
conv channels) with the shared B and C, so the chunk loop, the conv and
every product are per head, as the reference's constraints lay them out
(heads over tp).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import P
from repro_torch.models.layers import (
    activation_spec,
    constrain,
    is_dtensor,
    mesh_placements,
    on_shards,
    reduced,
    rms_norm,
    sharding_axes,
    weight,
)


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
    d_inner = expand * x_res.shape[-1]
    n_heads = d_inner // head_dim
    proj = constrain(x_res @ weight(p["in_proj"], x_res.dtype), "dp", None, "tp")  # (B, S, 2*di + 2N + H)
    leaves = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])

    def mix(proj, *leaves, h0=0, nh=n_heads):
        return _ssd_mix(proj, *leaves, n_heads=n_heads, head_dim=head_dim, d_state=d_state,
                        chunk=chunk, h0=h0, nh=nh)

    y = _ssd_on_mesh(mix, proj, leaves, n_heads) if is_dtensor(proj) else mix(proj, *leaves)
    y = rms_norm(y, p["gate_norm"], eps=norm_eps)
    return reduced(y @ weight(p["out_proj"], x_res.dtype))


def _ssd_on_mesh(mix, proj, leaves, n_heads: int) -> torch.Tensor:
    """The mixer on each rank's heads: the projection gathered over tp, heads
    [h0, h0 + nh) of tp rank r (all of them where tp does not divide the
    heads), the output (B, S, nh * head_dim) per rank."""
    axes = sharding_axes()
    split = n_heads % axes["tp_size"] == 0
    nh = n_heads // axes["tp_size"] if split else n_heads
    h0 = nh * proj.device_mesh.get_local_rank(axes["tp"]) if split else 0
    dp = activation_spec(proj.shape, ("dp",))[0]
    out = mesh_placements(proj, P(dp, None, axes["tp"] if split else None))
    whole = mesh_placements(proj, P())
    return on_shards(lambda pr, *lv: mix(pr, *lv, h0=h0, nh=nh), out_placements=out,
                     in_placements=(mesh_placements(proj, P(dp)),) + (whole,) * len(leaves)
                     )(proj, *leaves)


def _ssd_mix(proj, conv_w, conv_b, dt_bias, a_log, d_skip, *, n_heads: int, head_dim: int,
             d_state: int, chunk: int, h0: int, nh: int) -> torch.Tensor:
    """The SSD mixer from the input projection (B, S, 2*di + 2N + H) to the
    gated output y * silu(z) (B, S, nh * head_dim), before the gate norm, on
    heads [h0, h0 + nh) of the n_heads (all of them off a mesh)."""
    bsz, s, _ = proj.shape
    d_inner = n_heads * head_dim
    n = d_state
    if nh == n_heads:
        z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * n, n_heads], dim=-1)
    else:  # this rank's heads of z, x and dt, and its conv channels (its x, then B and C)
        c0, c1 = h0 * head_dim, (h0 + nh) * head_dim
        z = proj[..., c0:c1]
        xbc = torch.cat([proj[..., d_inner + c0:d_inner + c1],
                         proj[..., 2 * d_inner:2 * d_inner + 2 * n]], dim=-1)
        dt_raw = proj[..., 2 * d_inner + 2 * n + h0:2 * d_inner + 2 * n + h0 + nh]
        conv_w = torch.cat([conv_w[:, c0:c1], conv_w[:, d_inner:]], dim=-1)
        conv_b = torch.cat([conv_b[c0:c1], conv_b[d_inner:]])
        dt_bias, a_log, d_skip = dt_bias[h0:h0 + nh], a_log[h0:h0 + nh], d_skip[h0:h0 + nh]
        n_heads, d_inner = nh, nh * head_dim
    xbc = F.silu(causal_conv(xbc, conv_w, conv_b))
    x_in, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + dt_bias.float())  # (B, S, H)
    a = -torch.exp(a_log.float())  # (H,) negative
    da = dt * a  # (B, S, H) log-decay per step

    q = chunk if s % chunk == 0 else s
    nc = s // q
    xh = constrain(x_in.reshape(bsz, nc, q, n_heads, head_dim).float(),
                   "dp", None, None, "tp", None)
    bh = b_in.reshape(bsz, nc, q, n).float()
    ch = c_in.reshape(bsz, nc, q, n).float()
    dtc = dt.reshape(bsz, nc, q, n_heads)
    ca = torch.cumsum(da.reshape(bsz, nc, q, n_heads), dim=2)  # inclusive log decay
    xw = xh * dtc[..., None]  # dt-weighted inputs

    # intra-chunk (quadratic within the chunk); the upper triangle's decay is
    # exp(-inf) = 0 instead of the reference's masked exp of a positive sum
    g = torch.einsum("bcin,bcjn->bcij", ch, bh)  # (B, nc, Q, Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=proj.device))
    diff = ca[:, :, :, None, :] - ca[:, :, None, :, :]  # (B, nc, Q, Q, H)
    att = constrain(g[..., None] * torch.exp(diff.masked_fill_(~tri[:, :, None], float("-inf"))),
                    "dp", None, None, None, "tp")
    del diff
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xw)
    del att

    # chunk summary states and the scan over chunks
    decay_to_end = torch.exp(ca[:, :, -1:, :] - ca)  # (B, nc, Q, H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bh, xw * decay_to_end[..., None])
    chunk_decay = torch.exp(ca[:, :, -1, :])  # (B, nc, H)
    # the state entering each chunk, stacked once as lax.scan stacks its
    # outputs: under autograd, writing each into a slice of one tensor would
    # copy the whole stack's gradient once a chunk in the backward
    states = [torch.zeros_like(s_chunk[:, 0])]
    for c in range(nc - 1):
        states.append(states[-1] * chunk_decay[:, c, :, None, None] + s_chunk[:, c])
    h_in = torch.stack(states, dim=1)

    # "bcin,bchpn,bcih->bcihp" with n summed out first
    y_inter = torch.einsum("bcin,bchpn->bcihp", ch, h_in) * torch.exp(ca)[..., None]

    y = y_intra + y_inter + d_skip.float()[None, None, None, :, None] * xh
    y = constrain(y.reshape(bsz, s, d_inner).to(proj.dtype), "dp", None, "tp")
    return y * F.silu(z)


def ssd_decode_step(x_tok: torch.Tensor, state: dict, p: dict, *, d_state: int,
                    head_dim: int, expand: int, norm_eps: float = 1e-6):
    """One-token recurrence.  x_tok: (B, 1, D); state: {conv: (B, cw-1, C),
    ssm: (B, H, P, N)}, both updated in place.  Returns (out, state)."""
    check_f32_matmul(x_tok)
    bsz, _, d_model = x_tok.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    n = d_state

    proj = x_tok @ weight(p["in_proj"], x_tok.dtype)
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
    return reduced(y @ weight(p["out_proj"], x_tok.dtype)), state
