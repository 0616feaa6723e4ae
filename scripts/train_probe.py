#!/usr/bin/env python3
"""Where a full-width training run's losses come from, on one NVIDIA GPU.

    python3 scripts/train_probe.py [--arch recurrentgemma-2b] [--steps 8] [--cause]
        [--layers N] [--set FIELD=VALUE ...] [--runs kernels_lr1e-3,plain_bwd_lr1e-3,...]

Runs from the root of a checkout on a machine with a card and nvcc; imports
``repro_torch`` from ``src/`` and nothing of ``repro`` or JAX.  Three runs
of ``make_train_step`` at the arch's full width and depth, each from the
same seed-0 params (accum 2, B 4, S 4,096 from ``synthetic_token_stream``,
remat "full", the batches the same in each run):

  kernels_lr1e-3    the port as it is: flash's backward kernels, AdamW lr 1e-3
  plain_bwd_lr1e-3  the same with the plain PyTorch backward
                    (``flash_attention_bwd_plain``) in place of the kernels
  kernels_lr3e-4    the kernels at lr 3e-4

Prints one JSON line per run (each step's loss, grad norm and host-clock
seconds, and the peak device memory), then the card's name and power limit.
If the kernels' run and the plain backward's agree step by step, a jump in
the loss is not the kernels'.

``--layers N`` runs the arch at full width and N layers (the depth cuts
of ``chip_smoke.py``'s train cells); ``--set FIELD=VALUE`` replaces a
field of its config (an int, a float, True, False or a word, e.g.
``rope_fraction=1.0``, ``n_kv=8``) for a run that asks which of the config's features a loss
curve follows; ``--runs`` picks some of the three runs.

With ``--cause``, one run of the kernels at lr 1e-3 instead, read where a
jump comes from: the loss of each of the first 6 batches (forward only, in
the step's 2 microbatches) at the seed-0 params and after each of 5 steps.
A batch that is hard has a high loss at every params; params that a step
made worse have a high loss on every batch.  Then, at the params after
step 4, the first recurrent layer's RG-LRU block at the run's shapes (B 2,
S 4,096, its input the batch-5 embeddings after the layer's norm, f32)
against the same block with a sequential scan (h_t = a_t h_{t-1} + b_t,
one step at a time) in place of the log-depth one: the relative L2 error
of its output and of the gradient of every input and leaf under one
random cotangent, and how close the gates a come to 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import init_lm_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step, synthetic_token_stream

    argv = sys.argv[1:]
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else "recurrentgemma-2b"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 8
    dev = torch.device("cuda")
    build.build_all()  # before the clock
    changes = {"accum_steps": 2}
    if "--layers" in argv:
        changes["n_layers"] = int(argv[argv.index("--layers") + 1])
    for i, a in enumerate(argv):
        if a == "--set":
            field, value = argv[i + 1].split("=", 1)
            changes[field] = ({"True": True, "False": False}[value] if value in ("True", "False")
                              else next((cast(value) for cast in (int, float)
                                         if _parses(cast, value)), value))
    full = dataclasses.replace(get_config(arch), **changes)
    picked = argv[argv.index("--runs") + 1].split(",") if "--runs" in argv else None
    stream = synthetic_token_stream(full, 4, 4096)
    if "--cause" in argv:
        cause(full, [next(stream) for _ in range(6)], dev)
        print(card(), flush=True)
        return 0
    batches = [next(stream) for _ in range(steps)]
    kernels = tfa.flash_attention_bwd_cuda

    def plain(q, k, v, o, lse, do, **kw):
        return tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)

    for label, lr, backward in (("kernels_lr1e-3", 1e-3, kernels),
                                ("plain_bwd_lr1e-3", 1e-3, plain),
                                ("kernels_lr3e-4", 3e-4, kernels)):
        if picked is not None and label not in picked:
            continue
        tfa.flash_attention_bwd_cuda = backward  # what FlashAttention.backward calls
        try:
            params = init_lm_params(0, full, dev)
            opt = adamw_init(params)
            step = make_train_step(full, AdamWConfig(lr=lr))
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "s": time.perf_counter() - t0})
        finally:
            tfa.flash_attention_bwd_cuda = kernels
        print(json.dumps({"run": label, "arch": arch, "config_changes": changes, "lr": lr,
                          "steps": rows,
                          "max_memory_allocated": torch.cuda.max_memory_allocated()}), flush=True)
        del params, opt
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


def _parses(cast, value: str) -> bool:
    try:
        cast(value)
    except ValueError:
        return False
    return True


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cause(full, batches, dev) -> None:
    """The --cause run (see the module's docstring): JSON lines."""
    import torch

    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.step import batch_to, loss_for

    loss_fn = loss_for(full)

    def loss_of(params, batch):
        """The step's loss of ``batch`` at ``params``: its 2 microbatches' mean."""
        batch = batch_to(batch, dev)
        half = batch["tokens"].shape[0] // 2
        with torch.no_grad():
            return sum(float(loss_fn(params, {k: v[i : i + half] for k, v in batch.items()}))
                       for i in (0, half)) / 2

    params = lm.init_lm_params(0, full, dev)
    opt = adamw_init(params)
    step = make_train_step(full, AdamWConfig(lr=1e-3))
    rows = [{"after_step": 0, "loss_of_batch": [loss_of(params, b) for b in batches]}]
    print(json.dumps(rows[-1]), flush=True)
    for k, batch in enumerate(batches[:5], start=1):
        params, opt, m = step(params, opt, batch)
        rows.append({"after_step": k, "step_loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "loss_of_batch": [loss_of(params, b) for b in batches]})
        print(json.dumps(rows[-1]), flush=True)
        if k == 4:
            print(json.dumps(rglru_against_sequential(params, full, batches[4], dev)), flush=True)


def rglru_against_sequential(params, full, batch, dev) -> dict:
    """The first recurrent layer's block with the log-depth scan and with a
    sequential one, in f32 at the batch's first microbatch (see --cause)."""
    import torch

    from repro_torch.models import lm, rglru
    from repro_torch.models.layers import rms_norm

    layer = int(list(lm.layer_types(full)).index(1))
    leaves = {k: v[layer].detach().clone() for k, v in params["blocks"]["rglru"].items()}
    tokens = torch.as_tensor(batch["tokens"][:2], device=dev).long()
    with torch.no_grad():
        x = rms_norm(lm._inputs(params, tokens, None), params["blocks"]["ln1"][layer],
                     full.norm_eps).float()
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = None

    def sequential(a, b):
        h, out = torch.zeros_like(b[:, 0]), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, dim=1)

    runs = {}
    for label, scan in (("log_depth", rglru.linear_scan), ("sequential", sequential)):
        xs = x.clone().requires_grad_(True)
        ps = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        saved = rglru.linear_scan
        rglru.linear_scan = scan
        try:
            y = rglru.rglru_apply(xs, ps)
        finally:
            rglru.linear_scan = saved
        if cot is None:
            cot = torch.randn(y.shape, generator=gen, device=dev)
        y.backward(cot)
        runs[label] = {"y": y.detach(), "x": xs.grad, **{k: p.grad for k, p in ps.items()}}
    with torch.no_grad():
        branch = torch.nn.functional.silu(rglru.causal_conv(x @ leaves["w_x"], leaves["conv_w"],
                                                            leaves["conv_b"]))
        a, _ = rglru._gates(branch, leaves)
    rel = {k: float((runs["log_depth"][k] - v).norm() / v.norm().clamp_min(1e-30))
           for k, v in runs["sequential"].items()}
    return {"rglru_layer": layer, "shape": list(x.shape), "rel_l2_log_depth_vs_sequential": rel,
            "a_max": float(a.max()), "a_share_above_0.999": float((a > 0.999).float().mean()),
            "min_sqrt_1_minus_a2": float(torch.sqrt(torch.clamp(1 - a * a, min=1e-12)).min())}


if __name__ == "__main__":
    sys.exit(main())
