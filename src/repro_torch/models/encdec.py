"""Encoder-decoder backbone, seamless-m4t-large-v2 (port of
``repro.models.encdec``).

As in the reference, the audio frontend is a stub: the caller supplies frame
embeddings (B, S_src, d_model) and a learned projection stands in for the
modality bridge.  A bidirectional encoder and a causal decoder with
cross-attention, layers stacked and looped over.  On the card each
attention is one flash launch: the encoder's non-causal over all frames,
the decoder's causal, and the cross-attention non-causal over the encoder's
output (Sq != Sk).

Decoding writes the self-attention keys and values into the caller's cache
in place, as ``lm_decode_step`` does.  The cross K/V of the cache stay what
``init_encdec_cache`` made them, zeros, as in the reference: nothing fills
them (ROADMAP C6), so a decode step's cross-attention adds 0.

Training: ``encdec_loss`` is the encoder and the decoder, then the
decoder's chunked CE (``lm.chunked_loss``).  As in the reference, every
encoder and decoder layer is rematerialised in full (``jax.checkpoint``
whatever ``cfg.remat_policy`` says) when a gradient is wanted.

``encdec_param_specs`` and ``encdec_cache_specs`` are the reference's
sharding specs (``launch.mesh.P`` trees), read by ``launch.specs`` and
``launch.train --mesh``; the activations are pinned with
``layers.constrain`` at the reference's places (q, k and v on head_dim over
tp, as its ``_proj_qkv``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    chunked_attention,
    constrain,
    decode_attention,
    mlp_apply,
    reduced,
    rms_norm,
    rope,
    split_heads,
    weight,
)
from repro_torch.models.lm import (
    _attn_decode,
    _embed,
    _head_matrix,
    _layers,
    _positions,
    _remat,
    _wants_grad,
    attn_init,
    chunked_loss,
    mlp_init,
    padded_vocab,
    param_initializers,
)


def init_encdec_params(seed: int, cfg: ArchConfig,
                       device: str | torch.device | None = None) -> dict:
    """Random f32 params of the reference's names, shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (None: the
    card); other draws than the reference's (see ``init_lm_params``)."""
    d, nl, ne = cfg.d_model, cfg.n_layers, cfg.encoder_layers
    normal, dense, zeros = param_initializers(seed, nl, device)
    enc_dense = functools.partial(dense, layers=ne)
    return {
        "embed": normal((padded_vocab(cfg), d), 0.02),
        "frontend_proj": normal((d, d), d**-0.5),
        "enc_blocks": {"ln1": zeros(ne, d), "ln2": zeros(ne, d),
                       "attn": attn_init(cfg, enc_dense), "mlp": mlp_init(cfg, enc_dense)},
        "enc_norm": zeros(d),
        "dec_blocks": {"ln1": zeros(nl, d), "ln2": zeros(nl, d), "lnc": zeros(nl, d),
                       "attn": attn_init(cfg, dense), "cross": attn_init(cfg, dense),
                       "mlp": mlp_init(cfg, dense)},
        "final_norm": zeros(d),
    }


def encdec_param_specs(cfg: ArchConfig, serve_tp2d: bool = False) -> dict:
    """Sharding specs of :func:`init_encdec_params`' tree, the scheme of
    ``lm.lm_param_specs``."""
    both = ("data", "model")
    if serve_tp2d:
        d2, d2t = P(None, None, both), P(None, both, None)
        embed_spec, fp = P(both, None), P(None, both)
    else:
        d2, d2t = P(None, "data", "model"), P(None, "model", "data")
        embed_spec, fp = P("model", "data"), P("data", "model")
    attn_spec = {"wq": d2, "wk": d2, "wv": d2, "wo": d2t}
    mlp_spec = {"w1": d2, "w2": d2t}
    if cfg.activation == "silu_glu":
        mlp_spec = dict(mlp_spec, w1g=d2)
    return {
        "embed": embed_spec,
        "frontend_proj": fp,
        "enc_blocks": {"ln1": P(None, None), "ln2": P(None, None), "attn": attn_spec,
                       "mlp": mlp_spec},
        "enc_norm": P(None),
        "dec_blocks": {"ln1": P(None, None), "ln2": P(None, None), "lnc": P(None, None),
                       "attn": attn_spec, "cross": attn_spec, "mlp": mlp_spec},
        "final_norm": P(None),
    }


def _ffn(c, bp, cfg: ArchConfig):
    return c + mlp_apply(rms_norm(c, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg.activation)


def _proj(h, w, cfg: ArchConfig, heads: int):
    return constrain(split_heads(h @ w.to(h.dtype), heads, cfg.head_dim), "dp", None, None, "tp")


def _attn(c, bp, cfg: ArchConfig, positions, causal: bool):
    """Self-attention of a block (the reference's, with ``_proj``'s
    head_dim-pinned q, k and v)."""
    h = rms_norm(c, bp["ln1"], cfg.norm_eps)
    q = _proj(h, bp["attn"]["wq"], cfg, cfg.n_heads)
    k = _proj(h, bp["attn"]["wk"], cfg, cfg.n_kv)
    v = _proj(h, bp["attn"]["wv"], cfg, cfg.n_kv)
    q = rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk)
    return reduced(o.reshape(c.shape[0], c.shape[1], cfg.attn_dim)
                   @ weight(bp["attn"]["wo"], h.dtype))


def encode(params, cfg: ArchConfig, src_embeds):
    """src_embeds: (B, S_src, D) frontend-stub frame embeddings -> the
    encoder's output (B, S_src, D) bf16."""
    x = src_embeds.to(COMPUTE_DTYPE) @ weight(params["frontend_proj"], COMPUTE_DTYPE)
    positions = _positions(x)

    def block(c, bp):
        c = constrain(c, "dp", None, None)
        c = c + _attn(c, bp, cfg, positions, causal=False)
        return constrain(_ffn(c, bp, cfg), "dp", None, None)

    policy = "full" if _wants_grad(x) else "none"
    for bp in _layers(params["enc_blocks"], cfg.encoder_layers):
        x = _remat(functools.partial(block, bp=bp), policy)(x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_apply(c, bp, cfg: ArchConfig, enc_out):
    h = rms_norm(c, bp["lnc"], cfg.norm_eps)
    q = _proj(h, bp["cross"]["wq"], cfg, cfg.n_heads)
    k = _proj(enc_out, bp["cross"]["wk"], cfg, cfg.n_kv)
    v = _proj(enc_out, bp["cross"]["wv"], cfg, cfg.n_kv)
    o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk)
    return reduced(o.reshape(c.shape[0], c.shape[1], cfg.attn_dim)
                   @ weight(bp["cross"]["wo"], h.dtype))


def _decoder_blocks(x, params, cfg: ArchConfig, enc_out, positions):
    def block(c, enc, bp):
        c = constrain(c, "dp", None, None)
        c = c + _attn(c, bp, cfg, positions, causal=True)
        c = c + _cross_apply(c, bp, cfg, enc)
        return constrain(_ffn(c, bp, cfg), "dp", None, None)

    policy = "full" if _wants_grad(x) or _wants_grad(enc_out) else "none"
    for bp in _layers(params["dec_blocks"], cfg.n_layers):
        x = _remat(functools.partial(block, bp=bp), policy)(x, enc_out)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def encdec_loss(params, cfg: ArchConfig, batch, *, loss_chunk: int = 1024):
    """The decoder's masked next-token CE given the source: batch holds
    ``src_embeds`` (B, S_src, D), ``tokens`` and ``labels`` (B, S)."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    x = _embed(params, batch["tokens"])
    h = _decoder_blocks(x, params, cfg, enc_out, _positions(x))
    return chunked_loss(h, _head_matrix(params), batch["labels"], cfg.vocab, loss_chunk)


def encdec_prefill(params, cfg: ArchConfig, src_embeds, tokens):
    """Encode the source and run the decoder context; last-position logits
    (B, Vp)."""
    enc_out = encode(params, cfg, src_embeds)
    x = _embed(params, tokens)
    h = _decoder_blocks(x, params, cfg, enc_out, _positions(x))
    return h[:, -1] @ weight(_head_matrix(params), h.dtype).T


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ArchConfig, batch: int, seq_len: int, src_len: int,
                      device: str | torch.device | None = None) -> dict:
    """Zeroed cache on ``device`` (None: the card): pos 0, self k and v
    (n_layers, batch, seq_len, n_kv, head_dim) and cross ck and cv
    (n_layers, batch, src_len, n_kv, head_dim), bf16."""
    dev = resolve_device(device)

    def zeros(length):
        return torch.zeros((cfg.n_layers, batch, length, cfg.n_kv, cfg.head_dim),
                           dtype=COMPUTE_DTYPE, device=dev)

    return {"pos": 0, "k": zeros(seq_len), "v": zeros(seq_len), "ck": zeros(src_len),
            "cv": zeros(src_len)}


def encdec_cache_specs(cfg: ArchConfig, *, batch_axis, seq_axis=None) -> dict:
    """Sharding specs of :func:`init_encdec_cache`'s tree: batch over
    ``batch_axis``, the self K/V's sequence over ``seq_axis``, head_dim over
    "model"."""
    return {
        "pos": P(),
        "k": P(None, batch_axis, seq_axis, None, "model"),
        "v": P(None, batch_axis, seq_axis, None, "model"),
        "ck": P(None, batch_axis, None, None, "model"),
        "cv": P(None, batch_axis, None, None, "model"),
    }


def encdec_decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decoder token against the cached self and cross K/V: tokens
    (B, 1) -> (logits (B, 1, Vp), cache), k and v written in place and pos
    advanced by one."""
    pos = cache["pos"]
    x = _embed(params, tokens)
    src_len = cache["ck"].shape[2]
    for i, bp in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
        b = x.shape[0]
        c = x + _attn_decode(x, bp, cfg, cache["k"][i], cache["v"][i], pos, None)
        h = rms_norm(c, bp["lnc"], cfg.norm_eps)
        q = _proj(h, bp["cross"]["wq"], cfg, cfg.n_heads)
        o = decode_attention(q, cache["ck"][i], cache["cv"][i], src_len)
        c = c + reduced(o.reshape(b, 1, cfg.attn_dim) @ weight(bp["cross"]["wo"], h.dtype))
        x = _ffn(c, bp, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = h @ weight(_head_matrix(params), h.dtype).T
    return logits, dict(cache, pos=pos + 1)
