"""Serving launcher of the port: batched greedy decoding through the
ServeEngine (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b [--reduced] [--device cpu]

The same flags as the reference, plus ``--device`` (default ``cuda``), for
every architecture of ``repro_torch.configs``, encdec included.  The params
are drawn from a torch generator seeded with 0 on the device, or restored
from ``--checkpoint`` (a flat ``.npz`` written by either package).
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_encdec_params, init_lm_params
from repro_torch.serving import Request, ServeEngine
from repro_torch.train.checkpoint import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params = init(0, cfg, args.device)
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint, params)

    engine = ServeEngine(params, cfg, batch_size=args.batch, max_len=128, device=args.device)
    for r in range(args.requests):
        engine.submit(Request(prompt=[(r * 7 + i) % cfg.vocab for i in range(5)],
                              max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in done)
    print(f"{cfg.name}: served {len(done)} requests, {total} tokens "
          f"in {dt:.1f}s ({total / dt:.0f} tok/s) on {engine.device}")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt={r.prompt} -> {r.generated}")
    return done


if __name__ == "__main__":
    main()
