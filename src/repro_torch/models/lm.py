"""Unified decoder LM covering the dense, moe, ssm, hybrid and vlm families
(port of ``repro.models.lm``).

As in the reference, layer params are stacked with a leading n_layers axis,
params are f32 and compute casts to bf16 (COMPUTE_DTYPE).  The reference's
``lax.scan`` over layers is a Python loop over that axis (the stacked
leaves unbound once, so that a layer's gradient is one slice of one stacked
gradient), and its ``lax.cond`` between a hybrid layer's two branches a
Python branch on ``layer_types(cfg)[i]``: the untaken branch's slices get a
zero gradient, as under ``lax.cond``.  Hybrid layers keep both branches'
params, as in the reference.  The vlm family prepends ``img_embeds @
img_proj`` to the token embeddings.

Training: ``lm_loss`` is the reference's masked next-token cross-entropy,
the head and CE in chunks of ``loss_chunk`` positions.  Where a gradient is
wanted, each layer runs under ``cfg.remat_policy`` (``_remat``: "full"
recomputes the layer in the backward, "dots" keeps its matrix products,
"none" keeps everything) and each loss chunk is recomputed in the
backward, so that one chunk's f32 logits are alive at a time; without a
gradient (prefill, ``lm_forward``) nothing is wrapped.

Decoding updates the cache in place (the reference returns a new cache):
``lm_decode_step`` writes each layer's new key and value, and the ssm and
hybrid families' conv and recurrent state, into the cache's tensors and
returns the same tensors, so a decode step allocates no second cache.
``cache["pos"]`` is a Python int.

``lm_param_specs`` and ``cache_specs`` are the reference's sharding specs
(``launch.mesh.P`` trees) of the params and the cache; ``launch.specs``
and ``launch.train --mesh`` lay the params and caches out by them, and the
forward pins its activations with ``layers.constrain`` at the reference's
places (a no-op off a mesh).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import Replicate
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    chunked_attention,
    constrain,
    decode_attention,
    is_dtensor,
    like,
    mlp_apply,
    on_shards,
    reduced,
    rms_norm,
    rope,
    split_heads,
    weight,
    write_slot,
)
from repro_torch.models.moe import moe_apply, moe_apply_dense
from repro_torch.models.rglru import rglru_apply, rglru_decode_step
from repro_torch.models.ssm import ssd_apply, ssd_decode_step

VOCAB_ALIGN = 256  # pad vocab so 16 (model) and 16 (data) both divide it
# leaves the reference reads in f32 (router softmax, SSD decay, RG-LRU gates):
# cast_for_compute leaves them so
F32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D", "w_r", "w_i", "b_r", "b_i", "lambda"})


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

def param_initializers(seed: int, nl: int, device: str | torch.device | None = None):
    """(normal, dense, zeros) drawing f32 tensors on ``device`` from one
    ``torch.Generator`` seeded with ``seed``: ``dense(shape, scale=None,
    layers=nl)`` is the reference's ``_dense_init`` over ``layers`` stacked
    layers, its scale 1/sqrt(fan_in) with fan_in = shape[-2].  On ``meta``
    (shapes without values, the counterpart of ``jax.eval_shape``) nothing
    is drawn and there is no generator."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(std)

    def dense(shape, scale=None, layers=nl):
        return normal((layers, *shape), 1.0 / np.sqrt(shape[-2]) if scale is None else scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return normal, dense, zeros


def attn_init(cfg: ArchConfig, dense) -> dict:
    """The attention leaves of one stack of layers."""
    d = cfg.d_model
    return {
        "wq": dense((d, cfg.attn_dim)),
        "wk": dense((d, cfg.kv_dim)),
        "wv": dense((d, cfg.kv_dim)),
        "wo": dense((cfg.attn_dim, d)),
    }


def mlp_init(cfg: ArchConfig, dense) -> dict:
    """The MLP leaves of one stack of layers."""
    mlp = {"w1": dense((cfg.d_model, cfg.d_ff)), "w2": dense((cfg.d_ff, cfg.d_model))}
    if cfg.activation == "silu_glu":
        mlp["w1g"] = dense((cfg.d_model, cfg.d_ff))
    return mlp


def init_lm_params(seed: int, cfg: ArchConfig, device: str | torch.device | None = None) -> dict:
    """Random f32 params of the reference's names, shapes and scales for
    every decoder family, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (None: the card).

    The draws are torch's, not ``jax.random``'s: the same seed gives other
    weights than the reference.  To compare with it, carry its weights over
    with :func:`params_from_numpy`."""
    nl, d = cfg.n_layers, cfg.d_model
    normal, dense, zeros = param_initializers(seed, nl, device)
    vp = padded_vocab(cfg)
    blocks: dict[str, Any] = {"ln1": zeros(nl, d)}
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        conv_dim = di + 2 * s.d_state
        blocks["ssm"] = {
            "in_proj": dense((d, 2 * di + 2 * s.d_state + nh)),
            "conv_w": dense((s.conv_width, conv_dim), scale=0.3),
            "conv_b": zeros(nl, conv_dim),
            "dt_bias": zeros(nl, nh),
            "A_log": zeros(nl, nh),
            "D": zeros(nl, nh).fill_(1.0),
            "gate_norm": zeros(nl, di),
            "out_proj": dense((di, d)),
        }
    else:
        blocks["attn"] = attn_init(cfg, dense)
        blocks["ln2"] = zeros(nl, d)
        if cfg.family == "moe":
            e = cfg.moe.n_experts
            blocks["moe"] = {"router": dense((d, e)), "w1": dense((e, d, cfg.d_ff)),
                             "w2": dense((e, cfg.d_ff, d))}
            if cfg.activation == "silu_glu":
                blocks["moe"]["w1g"] = dense((e, d, cfg.d_ff))
        else:
            blocks["mlp"] = mlp_init(cfg, dense)
        if cfg.family == "hybrid":
            lru = cfg.hybrid.lru_width or d
            blocks["rglru"] = {
                "w_x": dense((d, lru)),
                "w_gate": dense((d, lru)),
                "conv_w": dense((4, lru), scale=0.3),
                "conv_b": zeros(nl, lru),
                "w_r": dense((lru, lru)),
                "b_r": zeros(nl, lru),
                "w_i": dense((lru, lru)),
                "b_i": zeros(nl, lru),
                "lambda": zeros(nl, lru).fill_(0.5),
                "w_out": dense((lru, d)),
            }
    params: dict[str, Any] = {"embed": normal((vp, d), 0.02), "final_norm": zeros(d),
                              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["head"] = normal((vp, d), 0.02)
    if cfg.frontend == "vision":
        params["img_proj"] = normal((d, d), 1.0 / np.sqrt(d))
    return params


def lm_param_specs(cfg: ArchConfig, serve_tp2d: bool = False) -> dict:
    """Sharding specs of :func:`init_lm_params`' tree (the reference's
    scheme): weights over ("data", "model"), norms and f32 leaves whole
    (a ``P`` is immutable, so leaves may share one).

    serve_tp2d=True (decode-time, cfg.serve_sharding == "tp2d"): feature dims
    shard over BOTH mesh axes and nothing shards over d_model, so per-layer
    matmuls need no weight all-gathers -- decode psums activations instead.
    """
    both = ("data", "model")
    if serve_tp2d:
        d2 = P(None, None, both)  # (L, D, F): F over 256 ways
        d2t = P(None, both, None)  # (L, F, D): contract -> psum
        vec = P(None, both)
        embed_spec = P(both, None)  # padded vocab divides 256
    else:
        d2 = P(None, "data", "model")  # (L, D, F)-like
        d2t = P(None, "model", "data")  # (L, F, D)-like
        vec = P(None, "model")
        embed_spec = P("model", "data")
    specs: dict[str, Any] = {
        "embed": embed_spec,
        "final_norm": P(None),
        "blocks": {"ln1": P(None, None)},
    }
    blocks = specs["blocks"]
    if cfg.family == "ssm":
        blocks["ssm"] = {
            "in_proj": d2,
            "conv_w": P(None, None, both if serve_tp2d else "model"),
            "conv_b": vec,
            "dt_bias": P(None, None),
            "A_log": P(None, None),
            "D": P(None, None),
            "gate_norm": vec,
            "out_proj": d2t,
        }
    else:
        blocks["attn"] = {"wq": d2, "wk": d2, "wv": d2, "wo": d2t}
        blocks["ln2"] = P(None, None)
        if cfg.family == "moe":
            moe_d2 = P(None, None, None, both) if serve_tp2d else P(None, None, "data", "model")
            moe_d2t = P(None, None, both, None) if serve_tp2d else P(None, None, "model", "data")
            blocks["moe"] = {"router": P(None, None, None), "w1": moe_d2, "w2": moe_d2t}
            if cfg.activation == "silu_glu":
                blocks["moe"]["w1g"] = moe_d2
        else:
            blocks["mlp"] = {"w1": d2, "w2": d2t}
            if cfg.activation == "silu_glu":
                blocks["mlp"]["w1g"] = d2
        if cfg.family == "hybrid":
            blocks["rglru"] = {
                "w_x": d2,
                "w_gate": d2,
                "conv_w": P(None, None, both if serve_tp2d else "model"),
                "conv_b": vec,
                "w_r": d2,
                "b_r": vec,
                "w_i": d2,
                "b_i": vec,
                "lambda": vec,
                "w_out": d2t,
            }
    if not cfg.tie_embeddings:
        specs["head"] = embed_spec
    if cfg.frontend == "vision":
        specs["img_proj"] = P(None, both) if serve_tp2d else P("data", "model")
    return specs


def params_from_numpy(tree, device: str | torch.device | None = None):
    """A pytree of arrays (the reference's params, as numpy) as tensors on
    ``device`` (None: the card), the same nesting and dtypes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, dev) for key, val in tree.items()}
    return torch.as_tensor(np.array(tree), device=dev)


def cast_for_compute(params: dict) -> dict:
    """The params with every matrix that the forward casts to bf16 at each use
    (embeddings, head, projections, attention, MLP and expert weights, conv
    filters) cast once; norm scales and the leaves the forward reads in f32
    (:data:`F32_LEAVES`) stay f32.  The forward then computes the same
    numbers, and a decode step reads half the bytes."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = cast_for_compute(val)
        elif key.startswith("ln") or key.endswith("norm") or key in F32_LEAVES:
            out[key] = val
        else:
            out[key] = val.to(COMPUTE_DTYPE)
    return out


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _layers(tree: dict, n: int) -> list[dict]:
    """Every layer's slice of the stacked block params, each leaf unbound
    once: under autograd a leaf's gradient is then one stack of the layers'
    gradients (zeros for a layer that does not use it), where ``n``
    indexings would each add a full-size gradient."""
    out: list[dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = _layers(val, n) if isinstance(val, dict) else val.unbind(0)
        for layer, part in zip(out, parts):
            layer[key] = part
    return out


# the products that the "dots" policy keeps: 2-D matrix products, XLA's dots
# without batch dimensions (x @ w reaches aten.mm)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under a per-layer rematerialisation policy, as the reference's
    ``jax.checkpoint``: "full" recomputes everything in the backward, "dots"
    saves the 2-D matrix products (``checkpoint_dots_with_no_batch_dims``)
    and recomputes the rest, "none" is ``fn`` itself."""
    if policy == "none":
        return fn
    if policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_dots))
    if policy != "full":
        raise ValueError(f"remat_policy {policy!r}: full, dots or none")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _attn_apply(x, bp, cfg: ArchConfig, positions, window, causal: bool = True):
    b, s, _ = x.shape
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q = split_heads(h @ weight(bp["attn"]["wq"], h.dtype), cfg.n_heads, cfg.head_dim)
    k = split_heads(h @ weight(bp["attn"]["wk"], h.dtype), cfg.n_kv, cfg.head_dim)
    v = split_heads(h @ weight(bp["attn"]["wv"], h.dtype), cfg.n_kv, cfg.head_dim)
    # heads over tp where divisible (falls back per-dim inside constrain)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, None, "tp")
    v = constrain(v, "dp", None, None, "tp")
    q = rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=causal, window=window, q_chunk=cfg.q_chunk)
    o = constrain(o, "dp", None, "tp", None)
    return reduced(o.reshape(b, s, cfg.attn_dim) @ weight(bp["attn"]["wo"], h.dtype))


def _ffn_apply(x, bp, cfg: ArchConfig):
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        m = cfg.moe
        if cfg.moe_dense_decode and x.shape[1] == 1:
            return moe_apply_dense(h, bp["moe"], n_experts=m.n_experts, top_k=m.top_k,
                                   activation=cfg.activation)
        return moe_apply(h, bp["moe"], n_experts=m.n_experts, top_k=m.top_k,
                         capacity_factor=m.capacity_factor, activation=cfg.activation)
    return mlp_apply(h, bp["mlp"], cfg.activation)


def _block_apply(x, bp, layer_type: int, cfg: ArchConfig, positions):
    """One block; bp is the per-layer slice of the params."""
    if cfg.family == "ssm":
        s = cfg.ssm
        x = constrain(x, "dp", None, None)
        return x + ssd_apply(rms_norm(x, bp["ln1"], cfg.norm_eps), bp["ssm"],
                             d_state=s.d_state, head_dim=s.head_dim, expand=s.expand,
                             chunk=s.chunk, norm_eps=cfg.norm_eps)
    if cfg.family == "hybrid":
        x = constrain(x, "dp", None, None)
        if is_dtensor(x) and _wants_grad(x):
            # a zero term of the untaken branch's leaves, so that each layer's
            # slice of them gets a gradient: autograd's unbind fills a missing
            # one with a plain zero tensor, which does not stack with DTensors
            untaken = bp["rglru"] if layer_type == 0 else bp["attn"]
            x = x + (0.0 * sum(leaf.sum() for leaf in untaken.values())).to(x.dtype)
        if layer_type == 0:
            x = x + _attn_apply(x, bp, cfg, positions, cfg.hybrid.local_window)
        else:
            x = x + rglru_apply(rms_norm(x, bp["ln1"], cfg.norm_eps), bp["rglru"])
        return constrain(x + _ffn_apply(x, bp, cfg), "dp", None, None)
    # dense / moe / vlm
    x = constrain(x, "dp", None, None)
    x = x + _attn_apply(x, bp, cfg, positions, cfg.window)
    return constrain(x + _ffn_apply(x, bp, cfg), "dp", None, None)


def _run_blocks(x, params, cfg: ArchConfig, positions):
    policy = cfg.remat_policy if _wants_grad(x) else "none"
    for bp, lt in zip(_layers(params["blocks"], cfg.n_layers), layer_types(cfg)):
        block = functools.partial(_block_apply, bp=bp, layer_type=int(lt), cfg=cfg,
                                  positions=positions)
        x = _remat(block, policy)(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head_matrix(params):
    return params.get("head", params["embed"])


def _embed(params, tokens):
    if is_dtensor(tokens):
        return reduced(_embed_on_mesh(weight(params["embed"], COMPUTE_DTYPE), tokens))
    return params["embed"].to(COMPUTE_DTYPE)[tokens]


def _embed_on_mesh(table, tokens):
    """The lookup in a vocab-sharded table: each rank looks up the tokens
    in its rows and zeros the others', a partial sum over the axes that
    shard the vocab."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    (rows, _), (first, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)

    def lookup(tok, tab):
        at = tok - first
        mine = (at >= 0) & (at < rows)
        return tab[at.clamp(0, rows - 1)] * mine[..., None]

    out = tuple(Partial() if pl == Shard(0) else tp
                for pl, tp in zip(table.placements, tokens.placements))
    return on_shards(lookup, out_placements=out,
                     in_placements=(tuple(tokens.placements), tuple(table.placements)))(
        tokens, table)


def _positions(x):
    """0..S-1 for x (B, S, ...), on x's mesh where x is a DTensor."""
    return like(x, torch.arange(x.shape[1], device=x.device))


def _inputs(params, tokens, img_embeds, x=None):
    """Token embeddings (``x`` where given), after the projected image
    embeddings if given."""
    x = _embed(params, tokens) if x is None else x
    if img_embeds is None:
        return x
    img = img_embeds.to(COMPUTE_DTYPE) @ weight(params["img_proj"], COMPUTE_DTYPE)
    return torch.cat([img, x], dim=1)


def lm_forward(params, cfg: ArchConfig, tokens, img_embeds=None):
    """Full-sequence logits (B, S, Vp); with ``img_embeds`` (B, n_img, D) the
    sequence is the n_img image positions then the tokens."""
    x = _inputs(params, tokens, img_embeds)
    h = _run_blocks(x, params, cfg, _positions(x))
    return h @ weight(_head_matrix(params), h.dtype).T


def _chunk_ce(hs, head, labels, vocab: int):
    """One chunk's summed masked CE and its count of labels: logits = hs @
    head.T (bf16), in f32 log-softmax; labels past the vocab (padded rows)
    and negative ones are masked."""
    logits = constrain(hs @ head.T, "dp", None, "tp").float()
    lsf = torch.where(labels < vocab, labels, -1)
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        gold = reduced(_gold_on_mesh(logits, lsf.clamp(min=0).long()))
    else:
        gold = torch.gather(logits, -1, lsf.clamp(min=0)[..., None].long())[..., 0]
    mask = (lsf >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _gold_on_mesh(logits, labels):
    """Each label's logit from vocab-sharded logits (B, S, Vp): each rank
    reads the labels in its columns and zeros the others', a partial sum
    over the axes that shard the vocab."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    (_, _, cols), (_, _, first) = compute_local_shape_and_global_offset(
        logits.shape, logits.device_mesh, logits.placements)
    last = Shard(logits.ndim - 1)

    def gold(lg, lab):
        at = lab - first
        mine = (at >= 0) & (at < cols)
        return torch.gather(lg, -1, at.clamp(0, cols - 1)[..., None])[..., 0] * mine

    out = tuple(Partial() if pl == last else pl for pl in logits.placements)
    return on_shards(gold, out_placements=out, in_placements=(
        tuple(logits.placements), tuple(Replicate() if pl == last else pl
                                        for pl in logits.placements)))(logits, labels)


def chunked_loss(h, head, labels, vocab: int, loss_chunk: int = 1024):
    """Mean masked CE of h (B, S, D) against labels (B, S) over the head
    (Vp, D), in chunks of ``loss_chunk`` positions (all of S where it does
    not divide S); each chunk recomputed in the backward when a gradient is
    wanted."""
    head = weight(head, h.dtype)
    s = h.shape[1]
    chunk = loss_chunk if s % loss_chunk == 0 else s
    ce = _remat(_chunk_ce, "full") if _wants_grad(h) else _chunk_ce
    parts = [ce(h[:, c0:c0 + chunk], head, labels[:, c0:c0 + chunk], vocab)
             for c0 in range(0, s, chunk)]
    if len(parts) == 1:
        num, den = parts[0]
    else:
        num, den = (torch.stack(x).sum() for x in zip(*parts))
    return num / torch.clamp(den, min=1.0)


def lm_loss(params, cfg: ArchConfig, batch, *, loss_chunk: int = 1024):
    """Masked next-token CE (a scalar f32 tensor): batch holds ``tokens`` and
    ``labels`` (B, S) (negative labels masked) and, for vlm, ``img_embeds``
    (B, n_img, D), whose positions get label -1."""
    labels = batch["labels"]
    img = batch.get("img_embeds")
    x = _inputs(params, batch["tokens"], img,
                constrain(_embed(params, batch["tokens"]), "dp", None, None))
    if img is not None:
        pad = like(labels, torch.full(img.shape[:2], -1, dtype=labels.dtype,
                                      device=labels.device))
        labels = torch.cat([pad, labels], dim=1)
    h = _run_blocks(x, params, cfg, _positions(x))
    return chunked_loss(h, _head_matrix(params), labels, cfg.vocab, loss_chunk)


def lm_prefill(params, cfg: ArchConfig, tokens, img_embeds=None):
    """Prefill: run the full context, return last-position logits (B, Vp)."""
    x = _inputs(params, tokens, img_embeds)
    h = _run_blocks(x, params, cfg, _positions(x))
    return h[:, -1] @ weight(_head_matrix(params), h.dtype).T


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
    """Zeroed cache on ``device`` (None: the card), pos 0, the reference's
    leaves: k and v (n_layers, batch, window, n_kv, head_dim) bf16; ssm:
    conv (n_layers, batch, conv_width - 1, d_inner + 2 d_state) bf16 and ssm
    (n_layers, batch, heads, head_dim, d_state) f32 in their place; hybrid:
    also conv (n_layers, batch, 3, lru) bf16 and h (n_layers, batch, lru)
    f32."""
    dev = resolve_device(device)
    nl = cfg.n_layers
    cache: dict[str, Any] = {"pos": 0}
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        cache["conv"] = torch.zeros((nl, batch, s.conv_width - 1, di + 2 * s.d_state),
                                    dtype=COMPUTE_DTYPE, device=dev)
        cache["ssm"] = torch.zeros((nl, batch, di // s.head_dim, s.head_dim, s.d_state),
                                   dtype=torch.float32, device=dev)
        return cache
    shape = (nl, batch, cache_window(cfg, seq_len), cfg.n_kv, cfg.head_dim)
    cache["k"] = torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev)
    cache["v"] = torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev)
    if cfg.family == "hybrid":
        lru = cfg.hybrid.lru_width or cfg.d_model
        cache["conv"] = torch.zeros((nl, batch, 3, lru), dtype=COMPUTE_DTYPE, device=dev)
        cache["h"] = torch.zeros((nl, batch, lru), dtype=torch.float32, device=dev)
    return cache


def cache_specs(cfg: ArchConfig, *, batch_axis, seq_axis=None) -> dict:
    """Sharding specs of :func:`init_decode_cache`'s tree (batch over
    ``batch_axis``; for batch=1 long-context shapes pass batch_axis=None and
    seq_axis="data"): head_dim over "model", since the kv head count can be
    under the axis's 16 and the 64..256-wide head_dim always divides it."""
    specs: dict[str, Any] = {"pos": P()}
    if cfg.family == "ssm":
        specs["conv"] = P(None, batch_axis, None, "model")
        specs["ssm"] = P(None, batch_axis, "model", None, None)
        return specs
    specs["k"] = P(None, batch_axis, seq_axis, None, "model")
    specs["v"] = P(None, batch_axis, seq_axis, None, "model")
    if cfg.family == "hybrid":
        specs["conv"] = P(None, batch_axis, None, "model")
        specs["h"] = P(None, batch_axis, "model")
    return specs


def _attn_decode(x, bp, cfg: ArchConfig, k_cache, v_cache, pos: int, window):
    """One layer's attention for one token; writes k, v into the layer's
    cache slices in place."""
    b = x.shape[0]
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q = split_heads(h @ weight(bp["attn"]["wq"], h.dtype), cfg.n_heads, cfg.head_dim)
    k = split_heads(h @ weight(bp["attn"]["wk"], h.dtype), cfg.n_kv, cfg.head_dim)
    v = split_heads(h @ weight(bp["attn"]["wv"], h.dtype), cfg.n_kv, cfg.head_dim)
    posv = like(x, torch.full((1,), pos, dtype=torch.int32, device=x.device))
    q = rope(q, posv, cfg.rope_fraction, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_fraction, cfg.rope_theta)
    # head_dim over tp, as the cache: the QK contraction then partial-sums
    # over dh instead of gathering the cache every step
    q = constrain(q, "dp", None, None, "tp")
    k = constrain(k, "dp", None, None, "tp")
    v = constrain(v, "dp", None, None, "tp")
    s_cache = k_cache.shape[1]
    ring = window is not None and s_cache == window
    # past the last slot the write lands on the last slot, as the reference's
    # dynamic_update_slice clamps its start, and every slot is attended
    slot = (pos % window) if ring else min(max(pos, 0), s_cache - 1)
    write_slot(k_cache, slot, k[:, 0])
    write_slot(v_cache, slot, v[:, 0])
    o = decode_attention(q, k_cache, v_cache, pos + 1, ring=ring)
    return reduced(o.reshape(b, 1, cfg.attn_dim) @ weight(bp["attn"]["wo"], h.dtype))


def lm_decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step: tokens (B, 1) -> (logits (B, 1, Vp), cache), the
    cache's tensors updated in place and its pos advanced by one."""
    pos = cache["pos"]
    x = _embed(params, tokens)
    for i, (bp, lt) in enumerate(zip(_layers(params["blocks"], cfg.n_layers), layer_types(cfg))):
        if cfg.family == "ssm":
            s = cfg.ssm
            out, _ = ssd_decode_step(
                rms_norm(x, bp["ln1"], cfg.norm_eps),
                {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, bp["ssm"],
                d_state=s.d_state, head_dim=s.head_dim, expand=s.expand, norm_eps=cfg.norm_eps)
            x = x + out
            continue
        if cfg.family == "hybrid" and lt == 1:
            out, _ = rglru_decode_step(rms_norm(x, bp["ln1"], cfg.norm_eps),
                                       {"conv": cache["conv"][i], "h": cache["h"][i]}, bp["rglru"])
        else:
            window = cfg.hybrid.local_window if cfg.family == "hybrid" else cfg.window
            out = _attn_decode(x, bp, cfg, cache["k"][i], cache["v"][i], pos, window)
        mid = x + out
        x = mid + _ffn_apply(mid, bp, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = h @ weight(_head_matrix(params), h.dtype).T
    return logits, dict(cache, pos=pos + 1)
