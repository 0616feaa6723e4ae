"""LM training launcher of the port (the counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --steps 50 --batch 8 --seq 64 [--device cpu]

The reference's flags, plus ``--accum`` (gradient-accumulation microbatches;
default: the config's ``accum_steps``, which ``--reduced`` sets to 1) and
``--device`` (default ``cuda``).  Params are drawn from a torch generator
seeded with 0 on the device, the batches come from
``synthetic_token_stream``, and the step is ``make_train_step`` with
``AdamWConfig(lr=--lr)``.  The loss is printed every ``steps // 10`` steps,
then the wall time; ``--checkpoint`` saves the final params as a flat
``.npz`` that either package loads.  ``--mesh`` (a sharded run over a device
mesh) waits with ROADMAP A.4 and raises.
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_encdec_params, init_lm_params
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    make_train_step,
    save_checkpoint,
    synthetic_token_stream,
)


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
    ap.add_argument("--mesh", default=None, help="not in the port yet (ROADMAP A.4)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: a sharded training run over a device mesh waits with the "
            "port's dry-run and mesh tooling (ROADMAP A.4); run on one device")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.accum is not None:
        cfg = dataclasses.replace(cfg, accum_steps=args.accum)
    dev = resolve_device(args.device)
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params = init(0, cfg, dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=args.lr))

    stream = synthetic_token_stream(cfg, args.batch, args.seq)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt, m = step(params, opt, next(stream))
        losses.append(float(m["loss"]))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s on {dev}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params)
        print(f"saved {args.checkpoint}")
    return params, losses


if __name__ == "__main__":
    main()
