"""Input specs and sharding specs for the dry run (port of
``repro.launch.specs``).

``build_dryrun(cfg, shape_name, mesh)`` returns what counting one
(architecture x input shape x mesh) step needs: the step function and its
arguments as ``meta`` tensors (shapes and dtypes, no storage; params and
optimizer state come from the real init functions on meta, the
counterpart of ``jax.eval_shape``), with the shardings of its inputs and
outputs.  Given a ``DeviceMesh`` (``launch.mesh.make_production_mesh``)
the arguments are meta DTensors laid out on it by their specs and the
shardings are placement trees; given axis sizes alone (``{"data": 1,
"model": 1}``: one card) the arguments are plain meta tensors and the
shardings the ``P`` trees.  ``roofline.step_cost(spec.step_fn,
*spec.args)`` counts it, per rank on a mesh.

Shapes (assigned):
    train_4k     seq 4,096    global_batch 256   -> train_step
    prefill_32k  seq 32,768   global_batch 32    -> prefill_step
    decode_32k   seq 32,768   global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524,288  global_batch 1     -> serve_step; requires a
                 sub-quadratic arch (SSM / hybrid / SWA) -- others are
                 skipped with a reason.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import P, data_axes, distribute_tree, mesh_axis_sizes, placements_tree
from repro_torch.models.encdec import (
    encdec_cache_specs,
    encdec_param_specs,
    init_encdec_cache,
    init_encdec_params,
)
from repro_torch.models.lm import cache_specs, init_decode_cache, init_lm_params, lm_param_specs
from repro_torch.train.optimizer import adamw_init, tree_map
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec(4096, 256, "train"),
    "prefill_32k": ShapeSpec(32768, 32, "prefill"),
    "decode_32k": ShapeSpec(32768, 128, "decode"),
    "long_500k": ShapeSpec(524288, 1, "decode"),
}

ENCDEC_DECODE_SRC = 4096  # cross-attention K/V length for decode shapes


@dataclasses.dataclass
class DryRunSpec:
    step_fn: Callable | None
    args: tuple
    in_shardings: Any
    out_shardings: Any
    skip: str | None = None  # reason, when the combination is skipped
    note: str = ""


def _init_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        return init_encdec_params, encdec_param_specs
    return init_lm_params, lm_param_specs


def sanitize_specs(abstract_tree, spec_tree, sizes: dict[str, int]):
    """Drop spec axes whose mesh size does not divide the dimension (the
    per-dimension fallback the reference's ``constrain`` applies to
    activations, here applied to parameter/cache specs -- e.g. chatglm's
    d_ff=13696 cannot shard 256-ways under tp2d and falls back to its
    largest valid axis).  Walks the dicts of ``abstract_tree``; its leaves
    are tensors, each with its ``P`` in ``spec_tree``."""
    if isinstance(abstract_tree, dict):
        return {key: sanitize_specs(val, spec_tree[key], sizes)
                for key, val in abstract_tree.items()}
    shape = abstract_tree.shape
    out = []
    for dim, entry in zip(shape, tuple(spec_tree) + (None,) * (len(shape) - len(spec_tree))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        # greedily keep the prefix of axes that still divides
        kept = []
        n = 1
        for a in axes:
            if dim % (n * sizes[a]) == 0:
                kept.append(a)
                n *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def param_abstract_and_shardings(cfg: ArchConfig, axis_sizes: dict[str, int],
                                 serve: bool = False):
    """The params from the real init on meta (seed 0) and their sanitized
    specs."""
    init, spec_fn = _init_fn(cfg)
    params = init(0, cfg, "meta")
    tp2d = serve and cfg.serve_sharding == "tp2d"
    specs = sanitize_specs(params, spec_fn(cfg, serve_tp2d=tp2d), axis_sizes)
    return params, specs


def opt_abstract_and_shardings(params, param_sh):
    opt = adamw_init(params)
    return opt, {"m": param_sh, "v": param_sh, "step": P()}


def _batch_abstract(cfg: ArchConfig, batch: int, seq: int, *, dp):
    """Training/prefill batch on meta (int32 tokens and labels, f32
    embeddings, as the reference's) + specs."""
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs: dict[str, Any] = {}
    sh: dict[str, Any] = {}
    if cfg.family == "encdec":
        specs["src_embeds"] = t((batch, seq, cfg.d_model), torch.float32)
        specs["tokens"] = t((batch, seq), torch.int32)
        specs["labels"] = t((batch, seq), torch.int32)
        sh["src_embeds"] = P(dp, None, None)
        sh["tokens"] = P(dp, None)
        sh["labels"] = P(dp, None)
        return specs, sh
    text = seq - (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    specs["tokens"] = t((batch, text), torch.int32)
    specs["labels"] = t((batch, text), torch.int32)
    sh["tokens"] = P(dp, None)
    sh["labels"] = P(dp, None)
    if cfg.family == "vlm":
        specs["img_embeds"] = t((batch, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
        sh["img_embeds"] = P(dp, None, None)
    return specs, sh


def build_dryrun(
    cfg: ArchConfig, shape_name: str, mesh, *, batch_override: int | None = None,
) -> DryRunSpec:
    """The step of ``shape_name`` for ``cfg`` on ``mesh``: a ``DeviceMesh``
    (its arguments meta DTensors, its shardings placements) or a dict of
    axis sizes (e.g. ``launch.mesh.production_axis_sizes()``; ``{"data": 1,
    "model": 1}`` for one card: plain meta arguments, ``P`` specs);
    ``batch_override`` replaces the shape's global batch."""
    if isinstance(mesh, dict):
        return _build(cfg, shape_name, mesh, batch_override)
    spec = _build(cfg, shape_name, mesh_axis_sizes(mesh), batch_override)
    if spec.skip:
        return spec
    return dataclasses.replace(
        spec, args=distribute_tree(spec.args, spec.in_shardings, mesh),
        in_shardings=placements_tree(spec.in_shardings, mesh),
        out_shardings=placements_tree(spec.out_shardings, mesh))


def _build(cfg: ArchConfig, shape_name: str, axis_sizes: dict[str, int],
           batch_override: int | None) -> DryRunSpec:
    shape = SHAPES[shape_name]
    if batch_override is not None:
        shape = dataclasses.replace(shape, batch=batch_override)
    dp = data_axes(axis_sizes)
    dp_size = 1
    for ax in (dp if isinstance(dp, tuple) else (dp,)):
        dp_size *= axis_sizes[ax]

    if shape.kind == "decode" and shape_name == "long_500k" and not cfg.sublquadratic:
        return DryRunSpec(
            step_fn=None, args=(), in_shardings=None, out_shardings=None,
            skip=f"{cfg.name} is full-quadratic attention; long_500k needs "
                 "a sub-quadratic arch (SSM/hybrid/SWA) — skipped per DESIGN.md §4",
        )

    params, param_sh = param_abstract_and_shardings(
        cfg, axis_sizes, serve=shape.kind == "decode"
    )
    if shape.kind == "decode" and cfg.serve_params_dtype == "bfloat16":
        params = tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
                          params)

    if shape.kind == "train":
        accum = max(1, min(cfg.accum_steps, shape.batch // dp_size))
        cfg_run = dataclasses.replace(cfg, accum_steps=accum)
        batch_abs, batch_sh = _batch_abstract(cfg_run, shape.batch, shape.seq, dp=dp)
        opt, opt_sh = opt_abstract_and_shardings(params, param_sh)
        metrics_sh = {"loss": P(), "grad_norm": P()}
        return DryRunSpec(
            step_fn=make_train_step(cfg_run),
            args=(params, opt, batch_abs),
            in_shardings=(param_sh, opt_sh, batch_sh),
            out_shardings=(param_sh, opt_sh, metrics_sh),
            note=f"accum_steps={accum}",
        )

    if shape.kind == "prefill":
        batch_abs, batch_sh = _batch_abstract(cfg, shape.batch, shape.seq, dp=dp)
        return DryRunSpec(
            step_fn=make_prefill_step(cfg),
            args=(params, batch_abs),
            in_shardings=(param_sh, batch_sh),
            out_shardings=P(dp, None),  # (B, Vp) last-position logits
        )

    # decode
    batch_axis = dp if shape.batch >= dp_size else None
    seq_axis = "data" if batch_axis is None else None
    if cfg.family == "encdec":
        cache = init_encdec_cache(cfg, shape.batch, shape.seq, ENCDEC_DECODE_SRC, "meta")
        cache_sh = encdec_cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
    else:
        cache = init_decode_cache(cfg, shape.batch, shape.seq, "meta")
        cache_sh = cache_specs(cfg, batch_axis=batch_axis, seq_axis=seq_axis)
    tokens = torch.empty((shape.batch, 1), dtype=torch.int32, device="meta")
    return DryRunSpec(
        step_fn=make_serve_step(cfg),
        args=(params, cache, tokens),
        in_shardings=(param_sh, cache_sh, P(batch_axis, None)),
        out_shardings=(P(batch_axis, None, None), cache_sh),
        note=f"cache_batch_axis={batch_axis} cache_seq_axis={seq_axis}",
    )
