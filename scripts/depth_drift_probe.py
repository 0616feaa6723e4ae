#!/usr/bin/env python3
"""How far prefill and sequential decode of one LM drift apart with depth,
on one NVIDIA GPU: the evidence behind ``chip_smoke.py``'s
``depth_logit_ulps``.

    python3 scripts/depth_drift_probe.py [--arch mamba2-2.7b] [--depths 2 8 16 32 48 64]

Runs from the root of a checkout on a machine with a card; imports
``repro_torch`` from ``src/`` and nothing of ``repro`` or JAX.  The arch's
full-width params from seed 0 on the card; for each depth, its first layers
run a 5-token prompt through ``make_prefill_step`` and through 5 steps of
``make_serve_step``, and the last logits are compared in bf16 ulps of the
logit scale (the largest |logit| of the prefill), as ``chip_smoke.py``
compares them.  At the deepest depth the same params also run on the CPU:
CPU prefill against CPU decode, and the card's prefill and decode against
the CPU's (one function each, computed twice).  One JSON line per depth,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def ulps(got, want) -> float:
    """max |got - want| in bf16 ulps at the largest |want|."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / 2.0 ** (math.frexp(scale)[1] - 8)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def run(params, cfg, prompt, dev):
    """(prefill logits, the 5th decode step's logits) of the prompt on dev."""
    from repro_torch.models.lm import init_decode_cache
    from repro_torch.train import make_prefill_step, make_serve_step

    want = make_prefill_step(cfg)(params, {"tokens": prompt.to(dev)})
    cache, step = init_decode_cache(cfg, 1, 8, dev), make_serve_step(cfg)
    for s in range(prompt.shape[1]):
        got, cache = step(params, cache, prompt[:, s : s + 1].to(dev))
    return want, got[:, 0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 8, 16, 32, 48, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("depth_drift_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm_params

    dev = torch.device("cuda")
    full = get_config(args.arch)
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, full.vocab, size=(1, 5)))
    params = init_lm_params(0, full, dev)
    for depth in args.depths:
        cfg = dataclasses.replace(full, n_layers=depth)
        cut = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        pre, dec = run(cut, cfg, prompt, dev)
        line = {"arch": args.arch, "n_layers": depth, "card_prefill_vs_card_decode": ulps(dec, pre)}
        if depth == max(args.depths):
            pre_c, dec_c = run(tree_map(lambda t: t.cpu(), cut), cfg, prompt, "cpu")
            line.update(cpu_prefill_vs_cpu_decode=ulps(dec_c, pre_c),
                        card_prefill_vs_cpu_prefill=ulps(pre.cpu(), pre_c),
                        card_decode_vs_cpu_decode=ulps(dec.cpu(), dec_c))
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
