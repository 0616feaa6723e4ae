"""Decoder LM, dense family (port of ``repro.models.lm``).

As in the reference, layer params are stacked with a leading n_layers axis,
params are f32 and compute casts to bf16 (COMPUTE_DTYPE).  The reference's
``lax.scan`` over layers is a Python loop over that axis; remat is not needed
for inference.  Decoding updates the KV cache in place (the reference returns
a new cache): ``lm_decode_step`` writes each layer's new key and value into
``cache["k"]`` and ``cache["v"]`` and returns the same tensors, so a decode
step allocates no second cache.  ``cache["pos"]`` is a Python int.

Only the dense family's inference is ported: moe, ssm, hybrid, vlm and
encdec raise ``NotImplementedError`` naming their ROADMAP item; training
(``lm_loss``) and the sharding specs are ROADMAP A14 and A13.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    chunked_attention,
    decode_attention,
    mlp_apply,
    rms_norm,
    rope,
)

VOCAB_ALIGN = 256  # pad vocab so 16 (model) and 16 (data) both divide it

_NOT_PORTED = {
    "moe": "ROADMAP A14 (moe: models/moe.py, the expert dispatch)",
    "ssm": "ROADMAP A14 (ssm: models/ssm.py, the SSD scan)",
    "hybrid": "ROADMAP A14 (hybrid: models/rglru.py, the RG-LRU recurrence)",
    "vlm": "ROADMAP A14 (vlm: the vision frontend and img_proj)",
    "encdec": "ROADMAP A14 (encdec: models/encdec.py)",
}


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a family this package does not run yet."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: {_NOT_PORTED[cfg.family]}"
        )
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def padded_vocab(cfg: ArchConfig) -> int:
    return (cfg.vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


def layer_types(cfg: ArchConfig) -> np.ndarray:
    """0 = attention layer, 1 = recurrent (rglru) layer."""
    if cfg.family != "hybrid":
        return np.zeros(cfg.n_layers, dtype=np.int32)
    pat = cfg.hybrid.pattern
    return np.asarray(
        [0 if pat[i % len(pat)] == "attn" else 1 for i in range(cfg.n_layers)],
        dtype=np.int32,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm_params(seed: int, cfg: ArchConfig, device: str | torch.device | None = None) -> dict:
    """Random f32 params of the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (None: the card).

    The draws are torch's, not ``jax.random``'s: the same seed gives other
    weights than the reference.  To compare with it, carry its weights over
    with :func:`params_from_numpy`."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nl, d = cfg.n_layers, cfg.d_model

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(std)

    def dense(shape):  # fan-in scaling of the reference's _dense_init
        return normal((nl, *shape), 1.0 / np.sqrt(shape[-2]))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    vp = padded_vocab(cfg)
    mlp = {"w1": dense((d, cfg.d_ff)), "w2": dense((cfg.d_ff, d))}
    if cfg.activation == "silu_glu":
        mlp["w1g"] = dense((d, cfg.d_ff))
    params: dict[str, Any] = {
        "embed": normal((vp, d), 0.02),
        "final_norm": zeros(d),
        "blocks": {
            "ln1": zeros(nl, d),
            "attn": {
                "wq": dense((d, cfg.attn_dim)),
                "wk": dense((d, cfg.kv_dim)),
                "wv": dense((d, cfg.kv_dim)),
                "wo": dense((cfg.attn_dim, d)),
            },
            "ln2": zeros(nl, d),
            "mlp": mlp,
        },
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((vp, d), 0.02)
    return params


def params_from_numpy(tree, device: str | torch.device | None = None):
    """A pytree of arrays (the reference's params, as numpy) as tensors on
    ``device`` (None: the card), the same nesting and dtypes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, dev) for key, val in tree.items()}
    return torch.as_tensor(np.array(tree), device=dev)


def cast_for_compute(params: dict) -> dict:
    """The params with every matrix that the forward casts to bf16 at each use
    (embed, head, the attention and MLP weights) cast once; norm scales stay
    f32.  The forward then computes the same numbers, and a decode step reads
    half the bytes."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = cast_for_compute(val)
        elif key.startswith("ln") or key.endswith("norm"):
            out[key] = val
        else:
            out[key] = val.to(COMPUTE_DTYPE)
    return out


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _layer(tree: dict, i: int) -> dict:
    """The i-th layer's slice of the stacked block params."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _attn_apply(x, bp, cfg: ArchConfig, positions, window):
    b, s, _ = x.shape
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q = (h @ bp["attn"]["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ bp["attn"]["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = (h @ bp["attn"]["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv, cfg.head_dim)
    q = rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True, window=window, q_chunk=cfg.q_chunk)
    return o.reshape(b, s, cfg.attn_dim) @ bp["attn"]["wo"].to(h.dtype)


def _ffn_apply(x, bp, cfg: ArchConfig):
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return mlp_apply(h, bp["mlp"], cfg.activation)


def _block_apply(x, bp, cfg: ArchConfig, positions):
    """One dense transformer block; bp is the per-layer slice of the params."""
    x = x + _attn_apply(x, bp, cfg, positions, cfg.window)
    return x + _ffn_apply(x, bp, cfg)


def _run_blocks(x, params, cfg: ArchConfig, positions):
    for i in range(cfg.n_layers):
        x = _block_apply(x, _layer(params["blocks"], i), cfg, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head_matrix(params):
    return params.get("head", params["embed"])


def _embed(params, tokens):
    return params["embed"].to(COMPUTE_DTYPE)[tokens]


def lm_forward(params, cfg: ArchConfig, tokens):
    """Full-sequence logits (B, S, Vp)."""
    check_ported(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h = _run_blocks(x, params, cfg, positions)
    return h @ _head_matrix(params).to(h.dtype).T


def lm_prefill(params, cfg: ArchConfig, tokens):
    """Prefill: run the full context, return last-position logits (B, Vp)."""
    check_ported(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h = _run_blocks(x, params, cfg, positions)
    return h[:, -1] @ _head_matrix(params).to(h.dtype).T


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def cache_window(cfg: ArchConfig, seq_len: int) -> int:
    """KV-cache length: full context, or the ring window for SWA archs."""
    if cfg.window is not None:
        return min(cfg.window, seq_len)
    if cfg.family == "hybrid":
        return min(cfg.hybrid.local_window, seq_len)
    return seq_len


def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      device: str | torch.device | None = None) -> dict:
    """Zeroed KV cache on ``device`` (None: the card): k and v
    (n_layers, batch, window, n_kv, head_dim) bf16, pos 0."""
    check_ported(cfg)
    dev = resolve_device(device)
    w = cache_window(cfg, seq_len)
    shape = (cfg.n_layers, batch, w, cfg.n_kv, cfg.head_dim)
    return {
        "pos": 0,
        "k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev),
        "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev),
    }


def _attn_decode(x, bp, cfg: ArchConfig, k_cache, v_cache, pos: int, window):
    """One layer's attention for one token; writes k, v into the layer's
    cache slices in place."""
    b = x.shape[0]
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q = (h @ bp["attn"]["wq"].to(h.dtype)).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = (h @ bp["attn"]["wk"].to(h.dtype)).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    v = (h @ bp["attn"]["wv"].to(h.dtype)).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_fraction, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_fraction, cfg.rope_theta)
    s_cache = k_cache.shape[1]
    ring = window is not None and s_cache == window
    # past the last slot the write lands on the last slot, as the reference's
    # dynamic_update_slice clamps its start, and every slot is attended
    slot = (pos % window) if ring else min(max(pos, 0), s_cache - 1)
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q, k_cache, v_cache, pos + 1, ring=ring)
    return o.reshape(b, 1, cfg.attn_dim) @ bp["attn"]["wo"].to(h.dtype)


def lm_decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step: tokens (B, 1) -> (logits (B, 1, Vp), cache), the
    cache's k and v updated in place and its pos advanced by one."""
    check_ported(cfg)
    pos = cache["pos"]
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        out = _attn_decode(x, bp, cfg, cache["k"][i], cache["v"][i], pos, cfg.window)
        mid = x + out
        x = mid + _ffn_apply(mid, bp, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = h @ _head_matrix(params).to(h.dtype).T
    return logits, dict(cache, pos=pos + 1)
