#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedNL on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the root of a checkout; imports ``repro_torch`` from ``src/`` and
nothing of ``repro`` or JAX.  Each phase prints one JSON line; any failure
raises, and the script exits non-zero without the final line.

  1 card     name, count, power limit (nvidia-smi), torch and CUDA versions
  2 build    nvcc of every kernel source, in parallel; seconds and ptxas report
  3 kernels  each kernel against its plain PyTorch version on the card, at the
             w8a shapes of the main path: SYRK within 1e-13 of max(|Z|^T|h||Z|),
             TopK bit-exact (u_hat bit patterns and sent) on the first rounds'
             corrections, near-ties, the keys-in-device-memory path and edge k
  4 main     repro_torch.api.solve on w8a (TopK, Option B, hess0="exact") on
             the card; launch counts, convergence, and the first 3 rounds' grad
             norms against the same spec on the CPU (plain versions)
  5 times    CUDA-event medians of each kernel, its plain version and its
             library yardstick at w8a shapes, beside the card's least time
  6 trace    torch.profiler over 3 rounds of the main path: device time by
             kernel and the device's busy share of the wall time
Then the kernels line, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA's data sheet for the H100 SXM at 700 W (dense): the least time the
# card could take is max(bytes / HBM rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12  # FP64 on the tensor cores
CUDA_CORE_32BIT_OPS = 67e12  # 32-bit ops outside the tensor cores

SYRK_TOL = 1e-13  # of max(|Z|^T |h| |Z|): FP64 sums of n_i = 348 terms, any order
TRAJECTORY_RTOL = 1e-8  # card vs CPU grad norms over the first 3 rounds
TIMED_REPS = 21  # event pairs per function; the median is reported
CALLS_PER_EVENT = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out.splitlines()[0]


def near_tie_rows(n_rows: int, t: int, seed: int) -> np.ndarray:
    """f64 entries, pairwise distinct, that collide in groups of four when
    rounded to f32 keys (the fixture of tests/test_kernels.py, batched)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_rows, -(-t // 4))).astype(np.float32).astype(np.float64)
    eps = np.array([0.0, 1e-12, 2.5e-12, -1e-12])
    u = (base[:, :, None] * (1.0 + eps)).reshape(n_rows, -1)[:, :t]
    return rng.permuted(u, axis=1)


def bits_equal(a, b) -> bool:
    """Bit-for-bit equality of two float64 tensors (+0.0 and -0.0 differ)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def median_ms(fns: dict) -> dict[str, float]:
    """Device ms per call of each function: CUDA events around
    CALLS_PER_EVENT back-to-back calls (so the queue runs ahead of the host
    and the host's launch cost hides behind the device's work where it can),
    median over TIMED_REPS such pairs, the functions in turns."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(TIMED_REPS):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS_PER_EVENT):
                fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {
        name: statistics.median(s.elapsed_time(e) for s, e in pairs) / CALLS_PER_EVENT
        for name, pairs in events.items()
    }


def trace_rounds(round_fn, state, rounds: int) -> dict:
    """Device time by kernel over ``rounds`` rounds after one warm-up round,
    and the device's busy share of the host's wall time over the window
    (the profiler's own host cost included, so the share is a floor)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, _ = round_fn(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = round_fn(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        return {"rounds": rounds, "device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "rounds": rounds,
        "wall_ms_per_round": wall_us / rounds / 1e3,
        "device_ms_per_round": device_us / rounds / 1e3,
        "device_busy_share": device_us / wall_us,
        "kernel_launches_per_round": sum(e.count for e in kernels) / rounds,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_round": e.self_device_time_total / rounds / 1e3,
             "calls_per_round": e.count / rounds}
            for e in top
        ],
    }


def bound(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import DataSpec, ExperimentSpec, solve
    from repro_torch.compressors.select import rank_keys
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.compressor_select import (
        keys_in_shared_memory,
        select_topk_cuda,
        select_topk_plain,
    )
    from repro_torch.kernels.hessian_syrk import (
        hessian_syrk_packed_cuda,
        hessian_syrk_packed_plain,
    )
    from repro_torch.linalg import triu_size
    from repro_torch.objectives.logreg import logreg_oracles_packed

    dev = torch.device("cuda")

    # --- 1 card ------------------------------------------------------------
    smi = nvidia_smi_line()
    emit({
        "phase": "card",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })

    # --- 2 build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "built": sorted(reports),
        "ptxas": {
            name: [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
            for name, rep in reports.items()
        },
    })

    # --- 3 kernels against their plain versions, w8a shapes ---------------
    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=50, tol=1e-12)
    cfg = spec.fednl_config()
    z = torch.as_tensor(spec.data.build(), dtype=torch.float64, device=dev).contiguous()
    n_clients, n_i, d = z.shape
    t_len, k = triu_size(d), cfg.k_for(d)
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0.0, 1.0, size=(n_clients, n_i))
    hw = torch.as_tensor(sigma * (1.0 - sigma) / n_i, dtype=torch.float64, device=dev)

    h_kernel = hessian_syrk_packed_cuda(z, hw, cfg.lam)
    h_plain = hessian_syrk_packed_plain(z, hw, cfg.lam)
    scale = hessian_syrk_packed_plain(z.abs(), hw.abs(), 0.0).abs().max().item()
    syrk_err = (h_kernel - h_plain).abs().max().item()
    check(h_kernel.shape == (n_clients, t_len), f"SYRK shape {tuple(h_kernel.shape)}")
    check(bool(torch.isfinite(h_kernel).all()), "SYRK output not finite")
    check(syrk_err <= SYRK_TOL * scale, f"SYRK error {syrk_err} > {SYRK_TOL} * {scale}")

    state0 = fednl_init(z, cfg)
    state1, _ = make_fednl_round(z, cfg)(state0)
    delta0 = logreg_oracles_packed(z, state0.x, cfg.lam)[2] - state0.h_local
    delta1 = logreg_oracles_packed(z, state1.x, cfg.lam)[2] - state1.h_local
    d350 = triu_size(350)
    topk_cases = {
        "round0_delta": (delta0, k),
        "round1_delta": (delta1, k),
        "near_ties": (torch.as_tensor(near_tie_rows(n_clients, t_len, 1), device=dev), k),
        "keys_in_device_memory": (
            torch.as_tensor(near_tie_rows(8, d350, 2), device=dev), 8 * 350
        ),
        "k_is_1": (torch.as_tensor(near_tie_rows(4, 257, 3), device=dev), 1),
        "k_is_T": (torch.as_tensor(near_tie_rows(4, 130, 4), device=dev), 130),
    }
    topk_err = 0.0
    for name, (u, kk) in topk_cases.items():
        u = u.contiguous()
        got, sent = select_topk_cuda(u, kk)
        want, sent_want = select_topk_plain(u, kk)
        check(bits_equal(got, want), f"TopK {name}: u_hat differs from the plain version")
        check(torch.equal(sent, sent_want), f"TopK {name}: sent differs")
        check(int((got != 0).sum(-1).max()) <= kk, f"TopK {name}: more than k kept")
        topk_err = max(topk_err, (got - want).abs().max().item())
    check(keys_in_shared_memory(t_len, dev), "w8a keys should fit shared memory")
    check(not keys_in_shared_memory(d350, dev), "d=350 keys should not fit shared memory")
    torch.cuda.synchronize()
    emit({
        "phase": "kernels",
        "hessian_syrk_packed": {
            "max_abs_err": syrk_err, "scale": scale, "rel_err": syrk_err / scale,
            "tol": SYRK_TOL,
        },
        "select_topk": {
            "cases": sorted(topk_cases), "bit_exact": True, "max_abs_err": topk_err,
            "round0_delta_nonzero": int((delta0 != 0).sum()),
            "round1_delta_nonzero": int((delta1 != 0).sum()),
        },
    })
    del state0, state1, delta0, h_plain

    # --- 4 the main path ---------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = solve(spec)
    launches = ops.launch_counts()
    gn = rep.grad_norms
    check(rep.x.shape == (d,) and bool(np.all(np.isfinite(rep.x))), "final x not finite")
    check(rep.rounds >= 3 and bool(np.all(np.isfinite(gn))), f"grad norms {gn}")
    check(launches["select_topk"] == rep.rounds + 1,
          f"TopK launches {launches} for {rep.rounds} rounds + warm-up")
    check(launches["hessian_syrk_packed"] == rep.rounds + 2,
          f"SYRK launches {launches} for {rep.rounds} rounds + warm-up + init")
    check(gn[-1] <= gn[0] * 1e-6, f"grad norm fell only from {gn[0]} to {gn[-1]}")
    rep_cpu = solve(spec.replace(rounds=3, tol=0.0), device="cpu")
    rel = np.abs(gn[:3] - rep_cpu.grad_norms) / rep_cpu.grad_norms
    check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"card vs CPU grad norms differ: {rel}")
    check(list(rep.sent_bits[:3]) == list(rep_cpu.sent_bits), "sent_bits differ from CPU")
    emit({
        "phase": "main",
        "spec": "w8a topk option B hess0=exact rounds<=50 tol=1e-12",
        "device": rep.extras["device"],
        "rounds": rep.rounds,
        "grad_norms": gn.tolist(),
        "cpu_grad_norms_3": rep_cpu.grad_norms.tolist(),
        "cpu_rel_err_3": rel.tolist(),
        "init_time_s": rep.init_time_s,
        "wall_time_s": rep.wall_time_s,
        "ms_per_round": rep.wall_time_s / rep.rounds * 1e3,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
    })

    # --- 5 times at w8a shapes ------------------------------------------------
    zs = hw[..., None] * z
    keys = rank_keys(delta1)
    syrk_ms = median_ms({
        "kernel": lambda: hessian_syrk_packed_cuda(z, hw, cfg.lam),
        "plain": lambda: hessian_syrk_packed_plain(z, hw, cfg.lam),
        "library": lambda: torch.bmm(z.mT, zs),
    })
    topk_ms = median_ms({
        "kernel": lambda: select_topk_cuda(delta1, k),
        "plain": lambda: select_topk_plain(delta1, k),
        "library": lambda: torch.topk(keys, k, dim=-1),
    })
    syrk_bound = bound(
        (z.numel() + hw.numel() + h_kernel.numel()) * 8,
        2 * n_i * t_len * n_clients,
        FP64_TENSOR_FLOPS,
    )
    topk_bound = bound(
        delta1.numel() * 8 * 2 + n_clients * 4,
        2 * 33 * delta1.numel(),  # compare + count per key, 31 search + 2 final passes
        CUDA_CORE_32BIT_OPS,
    )
    emit({"phase": "times", "hessian_syrk_packed": syrk_ms, "select_topk": topk_ms,
          "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                  f"{CALLS_PER_EVENT} back-to-back calls, the three in turns"})

    # --- 6 where a round's device time goes (torch.profiler, 3 rounds) -------
    emit({"phase": "trace", **trace_rounds(make_fednl_round(z, cfg), fednl_init(z, cfg), 3)})

    kernels = [
        {
            "name": "hessian_syrk_packed", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hessian_syrk.cu",
            "replaces": "src/repro/kernels/hessian_syrk.py:64",
            "launches": launches["hessian_syrk_packed"], "max_abs_err": syrk_err,
            "ms": syrk_ms["kernel"], "plain_ms": syrk_ms["plain"],
            "bound_ms": syrk_bound[0], "bound_by": syrk_bound[1],
            "library_ms": syrk_ms["library"],
        },
        {
            "name": "select_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:67",
            "launches": launches["select_topk"], "max_abs_err": topk_err,
            "ms": topk_ms["kernel"], "plain_ms": topk_ms["plain"],
            "bound_ms": topk_bound[0], "bound_by": topk_bound[1],
            "library_ms": topk_ms["library"],
        },
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
