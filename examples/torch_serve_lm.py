"""Serve a reduced assigned architecture on the PyTorch port: batched greedy
decode with a KV (or SSM-state) cache, the serve step the decode dry-run
shapes lower; the port of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma-2b [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_decode_cache, init_lm_params
from repro_torch.models.encdec import init_encdec_cache, init_encdec_params
from repro_torch.train import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if cfg.family == "encdec":
        params = init_encdec_params(0, cfg, dev)
        cache = init_encdec_cache(cfg, args.batch, args.tokens + 8, 16, dev)
    else:
        params = init_lm_params(0, cfg, dev)
        cache = init_decode_cache(cfg, args.batch, args.tokens + 8, dev)
    step = make_serve_step(cfg)  # writes the cache in place

    with torch.no_grad():
        toks = torch.zeros((args.batch, 1), dtype=torch.int64, device=dev)
        logits, cache = step(params, cache, toks)  # the first step builds the kernels
        out = [torch.argmax(logits[:, 0, : cfg.vocab], dim=-1)]

        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, cache = step(params, cache, out[-1][:, None])
            out.append(torch.argmax(logits[:, 0, : cfg.vocab], dim=-1))
        seqs = torch.stack(out, dim=1).cpu()
        dt = time.perf_counter() - t0
    print(f"{cfg.name}: decoded {args.batch} x {args.tokens} tokens "
          f"({args.batch * (args.tokens - 1) / dt:.0f} tok/s on {dev})")
    for b in range(min(2, args.batch)):
        print(f"  seq[{b}]: {seqs[b][:16].tolist()} ...")
    return seqs


if __name__ == "__main__":
    main()
