"""Train a reduced assigned architecture on the PyTorch port for a few
hundred steps on the synthetic token stream; the loss must visibly
decrease.  Shows the LM side's substrate (optimizer, accumulation,
checkpointing); the port of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-2.7b --steps 100 [--device cpu]
"""

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_lm_params
from repro_torch.models.encdec import init_encdec_params
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    make_train_step,
    save_checkpoint,
    synthetic_token_stream,
)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import batch_to


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params = init(0, cfg, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name} reduced: {n_params / 1e6:.1f}M params, family={cfg.family}, on {dev}")

    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))  # updates params, m and v in place
    stream = synthetic_token_stream(cfg, args.batch, args.seq, seed=0)

    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, batch_to(next(stream), dev))
        losses.append(float(m["loss"]))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  gnorm {float(m['grad_norm']):.3f}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {args.steps} steps "
          f"({time.perf_counter() - t0:.1f}s)")
    if args.out:
        save_checkpoint(args.out, params)
        print(f"checkpoint saved to {args.out}")
    return losses


if __name__ == "__main__":
    main()
