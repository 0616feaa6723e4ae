#!/usr/bin/env python3
"""The peak device memory of a full-width train step, 32k prefill or
serving engine at several depths, on one NVIDIA GPU.

    python3 scripts/train_depth_probe.py [--arch chatglm3-6b:14,16,18 ...] [--steps 2]
        [--prefill mixtral-8x22b:1,2,5 ...] [--engine mixtral-8x22b:1,2,4 ...]

Runs from the root of a checkout on a machine with a card and nvcc; imports
``repro_torch`` from ``src/`` and nothing of ``repro`` or JAX.  For each
``ARCH:DEPTHS`` (default: the three dense configs that ``chip_smoke.py``
trains at depth cuts), each depth in turn: seed-0 params at full width and
that many layers, AdamW's state, and ``--steps`` steps of
``make_train_step`` as ``chip_smoke.py``'s train phase runs them (accum 2,
B 4, S 4,096 from ``synthetic_token_stream``, remat "full", lr 1e-3).
Prints one JSON line a depth: the params, their f32 state (params, grads,
m and v: 16 bytes a param), ``max_memory_allocated`` and the peak above the
state, each step's host-clock seconds and loss, or the out-of-memory error;
a depth after one that ran out of memory is not tried.  ``--prefill
ARCH:DEPTHS`` (a decoder LM) runs ``chip_smoke.py``'s zoo (b) instead: the
seed-0 f32 params at that depth and one 32k prefill at B 1 (twice: the
second timed), and prints the params' bytes, ``max_memory_allocated`` and
the peak above what was allocated before the call; ``--engine
ARCH:DEPTHS`` its (d): the params and ``ServeEngine`` (batch 4, max_len
128, its bf16 copy of the params) serving 6 requests of 5 + 12 tokens, and
the peak above the f32 params.  With ``--prefill`` or ``--engine`` and no
``--arch``, no train step runs.  Then the host's cores, memory and
``/dev/shm`` size, and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ("chatglm3-6b:15,17,19", "nemotron-4-15b:1,2", "yi-34b:4,5,6")


def probe(arch: str, depth: int, steps: int, dev) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step, synthetic_token_stream

    cfg = dataclasses.replace(get_config(arch), n_layers=depth, accum_steps=2)
    out = {"arch": arch, "n_layers": depth, "accum_steps": 2, "batch_seq": [4, 4096]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = opt = None
    try:
        params = init_lm_params(0, cfg, dev)
        n = sum(t.numel() for t in _leaves(params))
        out.update(params=n, state_bytes=16 * n)
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3))
        stream = synthetic_token_stream(cfg, 4, 4096)
        wall, losses = [], []
        for _ in range(steps):
            batch = next(stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        out.update(ok=True, max_memory_allocated=peak, peak_above_state=peak - 16 * n,
                   wall_s=wall, losses=losses)
    except torch.cuda.OutOfMemoryError as err:
        out.update(ok=False, error=str(err).splitlines()[0][:300],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    del params, opt
    torch.cuda.empty_cache()
    return out


def probe_prefill(arch: str, depth: int, dev) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params
    from repro_torch.train import make_prefill_step

    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    out = {"arch": arch, "n_layers": depth, "kind": "prefill_32k", "batch_seq": [1, 32768]}
    torch.cuda.empty_cache()
    params = None
    try:
        params = init_lm_params(0, cfg, dev)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(1, 32768)),
                                 device=dev)
        prefill = make_prefill_step(cfg)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall = []
        for _ in range(2):
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            del logits
        peak = torch.cuda.max_memory_allocated()
        out.update(ok=True, param_bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
                   memory_allocated_before=before, max_memory_allocated=peak,
                   peak_above_before=peak - before, wall_s=wall)
    except torch.cuda.OutOfMemoryError as err:
        out.update(ok=False, error=str(err).splitlines()[0][:300],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    del params
    torch.cuda.empty_cache()
    return out


def probe_engine(arch: str, depth: int, dev) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    out = {"arch": arch, "n_layers": depth, "kind": "serve_engine", "batch": 4, "max_len": 128}
    torch.cuda.empty_cache()
    params = engine = None
    try:
        params = init_lm_params(0, cfg, dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(params, cfg, batch_size=4, max_len=128, device=dev)
        for r in range(6):
            engine.submit(Request(prompt=[(r * 7 + i) % cfg.vocab for i in range(5)],
                                  max_new_tokens=12))
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out.update(ok=True, param_bytes=before, max_memory_allocated=peak,
                   peak_above_params=peak - before, steps=engine.steps,
                   ms_per_step=wall / engine.steps * 1e3)
    except torch.cuda.OutOfMemoryError as err:
        out.update(ok=False, error=str(err).splitlines()[0][:300],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    del params, engine
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_depth_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    argv = sys.argv[1:]
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 2
    others = {flag: [argv[i + 1] for i, a in enumerate(argv) if a == flag]
              for flag in ("--prefill", "--engine")}
    plans = [argv[i + 1] for i, a in enumerate(argv) if a == "--arch"]
    if not plans and not any(others.values()):
        plans = list(DEFAULT)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    runs = [(plan, lambda a, n: probe(a, n, steps, dev)) for plan in plans]
    runs += [(plan, lambda a, n: probe_prefill(a, n, dev)) for plan in others["--prefill"]]
    runs += [(plan, lambda a, n: probe_engine(a, n, dev)) for plan in others["--engine"]]
    for plan, fn in runs:
        arch, depths = plan.split(":")
        for depth in map(int, depths.split(",")):
            row = fn(arch, depth)
            print(json.dumps(row), flush=True)
            if not row["ok"]:
                break
    shm = os.statvfs("/dev/shm")
    pages = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    print(json.dumps({"host": {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
                               "memory_bytes": pages,
                               "dev_shm_bytes": shm.f_blocks * shm.f_frsize,
                               "dev_shm_free_bytes": shm.f_bavail * shm.f_frsize}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
