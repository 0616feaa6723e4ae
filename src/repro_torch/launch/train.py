"""LM training launcher of the port (the counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --steps 50 --batch 8 --seq 64 [--device cpu] [--mesh 1x1]

The reference's flags, plus ``--accum`` (gradient-accumulation microbatches;
default: the config's ``accum_steps``, which ``--reduced`` sets to 1) and
``--device`` (default ``cuda``).  Params are drawn from a torch generator
seeded with 0 on the device, the batches come from
``synthetic_token_stream``, and the step is ``make_train_step`` with
``AdamWConfig(lr=--lr)``.  The loss is printed every ``steps // 10`` steps,
then the wall time; ``--checkpoint`` saves the final params as a flat
``.npz`` that either package loads.

``--mesh DATAxMODEL`` trains on a (data, model) ``DeviceMesh`` over the
default process group's ranks, as the reference's ``--mesh`` over its
devices: the params and AdamW's state are DTensors laid out by
``lm_param_specs`` / ``encdec_param_specs``, each batch is sharded over
data, and the activations are pinned by ``layers.constrain``.  A process
outside any group is a world of one (``distributed.world_of_one``: on the
card NCCL, so ``--mesh 1x1``); spawned ranks that joined a group of N
before calling :func:`main` take a mesh of N.  A mesh whose product is not
the group's size is refused.
"""

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P, data_axes, distribute_tree, make_mesh, mesh_axis_sizes
from repro_torch.launch.specs import sanitize_specs
from repro_torch.models import init_encdec_params, init_lm_params
from repro_torch.models.encdec import encdec_param_specs
from repro_torch.models.lm import lm_param_specs
from repro_torch.models.layers import clear_sharding_axes, is_dtensor, set_sharding_axes
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    make_train_step,
    save_checkpoint,
    synthetic_token_stream,
)
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.step import batch_to


def parse_mesh(text: str) -> tuple[int, int]:
    """"AxB" -> (A, B), both at least 1."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) >= 1 for p in parts):
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2")
    return int(parts[0]), int(parts[1])


def mesh_for(text: str, device: torch.device):
    """The (data, model) mesh of ``text`` over the default group's ranks
    (a world of one where this process has none)."""
    from repro_torch.distributed.world import world_of_one

    dims = parse_mesh(text)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dims[0] * dims[1] != world:
        raise ValueError(f"--mesh {text} holds {dims[0] * dims[1]} ranks; the default process "
                         f"group has {world}")
    if not dist.is_initialized():
        world_of_one(device)
    return make_mesh(dims, ("data", "model"), device.type)


def train(cfg, params, *, steps: int, batch: int, seq: int, lr: float, mesh=None,
          log=print):
    """``steps`` AdamW steps of ``cfg`` from ``params`` on the token
    stream -> (final params, losses); params and m, v are updated in place.
    With a ``mesh`` the params, the optimizer state and each batch are laid
    out on it (the returned params whole on every rank)."""
    step = make_train_step(cfg, AdamWConfig(lr=lr))
    stream = synthetic_token_stream(cfg, batch, seq)
    dev = tree_leaves(params)[0].device
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        dp = data_axes(mesh.mesh_dim_names)
        set_sharding_axes(dp, "model", sizes)
        spec_fn = encdec_param_specs if cfg.family == "encdec" else lm_param_specs
        params = distribute_tree(params, sanitize_specs(params, spec_fn(cfg), sizes), mesh)
    opt = adamw_init(params)  # m and v laid out as the params
    if mesh is not None:
        opt["step"] = distribute_tree(opt["step"], P(), mesh)
    losses = []
    try:
        for i in range(steps):
            b = batch_to(next(stream), dev)
            if mesh is not None:
                b = distribute_tree(b, {k: P(dp) for k in b}, mesh)
            params, opt, m = step(params, opt, b)
            loss = m["loss"].to_local() if is_dtensor(m["loss"]) else m["loss"]
            losses.append(float(loss))
            if i % max(1, steps // 10) == 0:
                log(f"step {i:4d} loss {losses[-1]:.4f}")
    finally:
        if mesh is not None:
            clear_sharding_axes()
    if mesh is not None:
        del opt
        params = tree_map(lambda p: p.full_tensor(), params)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=None,
                    help="gradient-accumulation microbatches (default: the config's)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2' -> (data, model) mesh over the default group's ranks")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.accum is not None:
        cfg = dataclasses.replace(cfg, accum_steps=args.accum)
    dev = resolve_device(args.device)
    mesh = mesh_for(args.mesh, dev) if args.mesh else None
    lead = not dist.is_initialized() or dist.get_rank() == 0
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params

    t0 = time.perf_counter()
    params, losses = train(cfg, init(0, cfg, dev), steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr, mesh=mesh,
                           log=print if lead else lambda _: None)
    if lead:
        where = f"{dev}" + (f", mesh {args.mesh}" if mesh is not None else "")
        print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s on {where}")
    if args.checkpoint and lead:
        save_checkpoint(args.checkpoint, params)
        print(f"saved {args.checkpoint}")
    return params, losses


if __name__ == "__main__":
    main()
