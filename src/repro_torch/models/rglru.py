"""RG-LRU recurrent block (RecurrentGemma / Griffin; port of
``repro.models.rglru``).

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_r x_t + b_r)            (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference's ``jax.lax.associative_scan`` over the affine maps h -> a*h + b
becomes a log-depth (Hillis-Steele) scan in torch ops with the same
``combine``: ceil(log2 S) passes, each one elementwise product and sum over
the sequence (15 at S = 32,768), where a loop over S would be S launches and
differences of ``exp(cumsum(log a))`` would overflow.  The products of the
gates are f32 (``check_f32_matmul``).  Decoding writes the conv and
recurrent state into the caller's tensors in place.

On a mesh (DTensors) the branch is pinned with its lru features over tp
(the reference's constraint); the conv and the scan are per feature and
run on each rank's shards (``layers.on_shards``), the gates' products on
the DTensors.
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
    weight,
)
from repro_torch.models.ssm import causal_conv, check_f32_matmul, conv_step

_C = 8.0


def _gates(xf: torch.Tensor, p: dict):
    """f32 branch input -> (a, the gated input sqrt(1 - a^2) * i * x)."""
    r = torch.sigmoid(xf @ weight(p["w_r"], torch.float32) + p["b_r"])
    i = torch.sigmoid(xf @ weight(p["w_i"], torch.float32) + p["b_i"])
    a = torch.exp(-_C * F.softplus(p["lambda"].float()) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as the
    associative scan of combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2):
    pass d combines each element with the one d before it."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _rglru_core(x: torch.Tensor, p: dict, h0: torch.Tensor | None = None):
    """x: (B, S, L) recurrent-branch input -> (y in x's type, h_last f32)."""
    check_f32_matmul(x)
    xf = x.float()
    a, gated = _gates(xf, p)
    if h0 is not None:
        gated[:, 0] += a[:, 0] * h0.float()
    h = _per_feature(linear_scan, a, 2)(a, gated)
    return h.to(x.dtype), h[:, -1]


def _per_feature(fn, x: torch.Tensor, n_acts: int, leaf_specs=()):
    """``fn`` of ``n_acts`` (B, S, L) tensors laid out as ``x``, then leaves
    laid out by ``leaf_specs`` (each a function of the features' axis),
    elementwise over the features: on a mesh it runs on each rank's
    feature shard (batch over dp, features over tp where they divide);
    else ``fn`` itself."""
    if not is_dtensor(x):
        return fn
    spec = activation_spec(x.shape, ("dp", None, "tp"))
    pl = mesh_placements(x, spec)
    return on_shards(fn, out_placements=pl, in_placements=(pl,) * n_acts + tuple(
        mesh_placements(x, leaf(spec[2])) for leaf in leaf_specs))


def rglru_apply(x_res: torch.Tensor, p: dict) -> torch.Tensor:
    """Griffin recurrent block over a full sequence.  x_res: (B, S, D)."""
    branch = constrain(x_res @ weight(p["w_x"], x_res.dtype), "dp", None, "tp")
    gate = F.gelu(x_res @ weight(p["w_gate"], x_res.dtype), approximate="tanh")
    conv = _per_feature(causal_conv, branch, 1, (lambda tp: P(None, tp), lambda tp: P(tp)))
    branch = F.silu(conv(branch, p["conv_w"], p["conv_b"]))
    h, _ = _rglru_core(branch, p)
    return reduced((h * gate) @ weight(p["w_out"], x_res.dtype))


def rglru_decode_step(x_tok: torch.Tensor, state: dict, p: dict):
    """One token.  state: {conv: (B, cw-1, L), h: (B, L) f32}, both updated
    in place.  Returns (out (B, 1, D), state)."""
    check_f32_matmul(x_tok)
    branch = x_tok @ weight(p["w_x"], x_tok.dtype)  # (B, 1, L)
    gate = F.gelu(x_tok @ weight(p["w_gate"], x_tok.dtype), approximate="tanh")
    xf = F.silu(conv_step(state["conv"], branch, p["conv_w"], p["conv_b"])).float()
    a, gated = _gates(xf, p)
    h = state["h"]
    h.copy_(a * h.float() + gated)
    out = reduced((h.to(x_tok.dtype)[:, None, :] * gate) @ weight(p["w_out"], x_tok.dtype))
    return out, state
