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
             corrections, near-ties, the keys-in-device-memory path and edge k;
             RandSeqK bit-exact on the round's real draws, s = 0, s = T-1, a
             wrapping window, k = 1 and k = T; TopLEK exact (u_hat bits and
             kept) on the all-zero round-0 correction, the round-1 correction,
             near-ties, a dyadic fixture, k = 1, k = T and every memory path,
             but for rows where alpha_m* lies within 1e-12 of k/T or unif of p
             (counted; none allowed on the dyadic fixture)
  4 main     repro_torch.api.solve on w8a (Option B, hess0="exact") on the
             card, three paths, the launch counts set to 0 before each and
             read after it: TopK and TopLEK (tol 1e-12, <= 50 rounds), RandSeqK
             (30 rounds); launch counts, the grad norm falls, and the first 3
             rounds' grad norms and sent_bits against the same spec on the CPU
             (plain versions; the same threefry draws)
  5 times    CUDA-event medians of each kernel, its plain version and its
             library yardstick at w8a shapes, beside the card's least time
  6 trace    torch.profiler over 3 rounds of the TopK and of the TopLEK path:
             device time by kernel and the device's busy share of the wall
             time; the host's ms per round for the key split, the clients'
             keys and draws, and their upload
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
TOPLEK_BOUNDARY = 1e-12  # TopLEK's allowed difference: alpha_m* this near k/T, or unif near p
DRAW_REPS = 200  # host draw timing: rounds of draws averaged
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


def dyadic_rows(n_rows: int, t: int, seed: int) -> np.ndarray:
    """Entries +-2**-e, e in [0, 10], many exact ties: every sum of their
    squares is exact in any order (tests/test_torch_kernels.py's fixture)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 11, size=(n_rows, t))
    return np.where(rng.random((n_rows, t)) < 0.5, -1.0, 1.0) * np.ldexp(1.0, -e)


def toplek_near_boundary(u: np.ndarray, k: int, unif: float) -> bool:
    """Row u is TopLEK's allowed case of difference: alpha_m* (or alpha_m*-1)
    within TOPLEK_BOUNDARY of delta = k/T, or unif within it of p, with the
    prefix energies summed exactly rounded (math.fsum)."""
    import math

    t = u.shape[0]
    delta = k / t
    order = np.lexsort((np.arange(t), -np.abs(u).astype(np.float32)))[:k]
    total = math.fsum(u * u)
    if total == 0:
        return False
    sq = u[order] ** 2
    alphas = np.array([math.fsum(sq[: m + 1]) / total for m in range(k)])
    m_star = min(int(np.sum(alphas < delta)) + 1, k)
    hi = alphas[m_star - 1]
    lo = alphas[m_star - 2] if m_star > 1 else 0.0
    p = min(max((hi - delta) / (hi - lo), 0.0), 1.0) if hi > lo else 0.0
    return min(abs(hi - delta), abs(lo - delta), abs(unif - p)) <= TOPLEK_BOUNDARY


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


def host_draw_ms(prng, upload_draws, n_clients: int, t: int, device) -> dict:
    """Host ms per round of the PRNG work a round does, averaged over
    DRAW_REPS rounds: split(key), which every compressor's round does; the
    clients' keys split(sub, n_clients) and the draws, which a random
    compressor's round adds; and the draws' pinned upload (enqueued, not
    waited for)."""
    import torch

    key = prng.prng_key(0)
    t0 = time.perf_counter()
    for _ in range(DRAW_REPS):
        key, sub = prng.split(key, 2)
    out = {"n_clients": n_clients, "reps": DRAW_REPS,
           "key_split_ms_per_round": (time.perf_counter() - t0) / DRAW_REPS * 1e3}
    for name, draw in (("toplek", prng.uniform), ("randseqk", lambda ks: prng.randint(ks, 0, t))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DRAW_REPS):
            draws = draw(prng.split(sub, n_clients))
        t1 = time.perf_counter()
        for _ in range(DRAW_REPS):
            upload_draws(draws, device)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = {
            "client_keys_and_draws_ms_per_round": (t1 - t0) / DRAW_REPS * 1e3,
            "upload_ms_per_round": (t2 - t1) / DRAW_REPS * 1e3,
        }
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
    from repro_torch.compressors.core import upload_draws
    from repro_torch.compressors.select import randseqk_window_mask, rank_keys
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.compressor_select import (
        keys_in_shared_memory,
        select_randseqk_cuda,
        select_randseqk_plain,
        select_topk_cuda,
        select_topk_plain,
        select_toplek_cuda,
        select_toplek_plain,
        toplek_memory_path,
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

    # the draws of the main path's first two rounds (seed 0), as the round makes them
    round_keys, key = [], state0.key
    for _ in range(2):
        key, sub = prng.split(key, 2)
        round_keys.append(prng.split(sub, n_clients))
    wide = rng.standard_normal((4, 70000))
    randseqk_cases = {  # name: (u, k, s)
        "round0_draws": (delta1, k, prng.randint(round_keys[0], 0, t_len)),
        "round1_draws": (delta1, k, prng.randint(round_keys[1], 0, t_len)),
        "s_is_0": (delta1, k, np.zeros(n_clients, dtype=np.int64)),
        "s_is_T_minus_1": (delta1, k, np.full(n_clients, t_len - 1, dtype=np.int64)),
        "wrapping": (delta1, k, t_len - 1 - rng.integers(0, k, size=n_clients)),
        "k_is_1": (delta1, 1, rng.integers(0, t_len, size=n_clients)),
        "k_is_T": (delta1, t_len, rng.integers(0, t_len, size=n_clients)),
        "long_rows": (torch.as_tensor(wide, device=dev), 4096, np.array([0, 69999, 65000, 123])),
    }
    randseqk_err = 0.0
    for name, (u, kk, s_np) in randseqk_cases.items():
        u = u.contiguous()
        s = torch.as_tensor(s_np, dtype=torch.int64, device=dev)
        got, sent = select_randseqk_cuda(u, kk, s)
        want, sent_want = select_randseqk_plain(u, kk, s)
        check(bits_equal(got, want), f"RandSeqK {name}: u_hat differs from the plain version")
        check(torch.equal(sent, sent_want), f"RandSeqK {name}: sent differs")
        randseqk_err = max(randseqk_err, (got - want).abs().max().item())

    toplek_cases = {  # name: (u, k, unif, exact)
        "round0_delta": (delta0, k, prng.uniform(round_keys[0]), True),
        "round1_delta": (delta1, k, prng.uniform(round_keys[1]), False),
        "near_ties": (near_tie_rows(n_clients, t_len, 5), k, rng.uniform(size=n_clients), False),
        "dyadic": (dyadic_rows(n_clients, t_len, 6), k, rng.uniform(size=n_clients), True),
        "k_is_1": (near_tie_rows(8, t_len, 7), 1, rng.uniform(size=8), False),
        "k_is_T": (dyadic_rows(4, t_len, 8), t_len, rng.uniform(size=4), True),
        "k_is_T_small": (near_tie_rows(4, 130, 9), 130, rng.uniform(size=4), False),
        "keys_in_device_memory": (dyadic_rows(8, d350, 10), 8 * 350, rng.uniform(size=8), True),
    }
    toplek_err, toplek_boundary, toplek_kept = 0.0, {}, {}
    for name, (u, kk, unif_np, exact) in toplek_cases.items():
        u = torch.as_tensor(u, dtype=torch.float64, device=dev).contiguous()
        unif = torch.as_tensor(unif_np, dtype=torch.float64, device=dev)
        got, sent = select_toplek_cuda(u, kk, unif)
        want, sent_want = select_toplek_plain(u, kk, unif)
        torch.cuda.synchronize()
        check(sent.dtype == torch.int32, f"TopLEK {name}: sent dtype {sent.dtype}")
        differ = (~torch.all(got.view(torch.int64) == want.view(torch.int64), dim=-1)) | (
            sent != sent_want
        )
        rows = differ.nonzero().flatten().tolist()
        check(not (exact and rows), f"TopLEK {name}: rows {rows} differ on an exact fixture")
        u_host = u.cpu().numpy()
        for r in rows:
            check(abs(int(sent[r]) - int(sent_want[r])) == 1,
                  f"TopLEK {name}: row {r} kept {int(sent[r])} vs {int(sent_want[r])}")
            check(toplek_near_boundary(u_host[r], kk, float(unif_np[r])),
                  f"TopLEK {name}: row {r} differs away from the boundary")
        same = ~differ
        if bool(same.any()):
            toplek_err = max(toplek_err, (got[same] - want[same]).abs().max().item())
        check(int((got != 0).sum(-1).max()) <= kk, f"TopLEK {name}: more than k kept")
        toplek_boundary[name] = len(rows)
        toplek_kept[name] = [int(sent.min()), int(sent.max())]
    check(toplek_kept["round0_delta"] == [0, 0], "TopLEK keeps nothing of the zero round-0 delta")
    toplek_paths = {
        "w8a": toplek_memory_path(t_len, k, dev),
        "k_is_T": toplek_memory_path(t_len, t_len, dev),
        "keys_in_device_memory": toplek_memory_path(d350, 8 * 350, dev),
    }
    check(toplek_paths == {"w8a": 0, "k_is_T": 2, "keys_in_device_memory": 1},
          f"TopLEK memory paths {toplek_paths}")
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
        "select_randseqk": {
            "cases": sorted(randseqk_cases), "bit_exact": True, "max_abs_err": randseqk_err,
        },
        "select_toplek": {
            "cases": sorted(toplek_cases), "max_abs_err_exact_rows": toplek_err,
            "boundary_rows": toplek_boundary, "boundary_tol": TOPLEK_BOUNDARY,
            "kept_min_max": toplek_kept, "memory_paths": toplek_paths,
        },
    })
    del state0, state1, delta0, h_plain

    # --- 4 the main paths, the launch counts set to 0 before each ---------
    def main_path(label: str, path_spec, selector: str, cpu_rounds: int = 3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rep = solve(path_spec)
        launches = ops.launch_counts()
        gn = rep.grad_norms
        check(rep.x.shape == (d,) and bool(np.all(np.isfinite(rep.x))), f"{label}: x not finite")
        check(rep.rounds >= 3 and bool(np.all(np.isfinite(gn))), f"{label}: grad norms {gn}")
        want = {name: 0 for name in launches}
        want.update({selector: rep.rounds + 1, "hessian_syrk_packed": rep.rounds + 2})
        check(launches == want,
              f"{label}: launches {launches}, want {want} for {rep.rounds} rounds + warm-up (+ init)")
        check(gn[-1] < gn[0], f"{label}: grad norm did not fall: {gn[0]} -> {gn[-1]}")
        rep_cpu = solve(path_spec.replace(rounds=cpu_rounds, tol=0.0), device="cpu")
        rel = np.abs(gn[:cpu_rounds] - rep_cpu.grad_norms) / rep_cpu.grad_norms
        check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{label}: card vs CPU grad norms differ: {rel}")
        check(list(rep.sent_bits[:cpu_rounds]) == list(rep_cpu.sent_bits),
              f"{label}: sent_bits {rep.sent_bits[:cpu_rounds]} vs CPU {rep_cpu.sent_bits}")
        emit({
            "phase": "main",
            "path": label,
            "device": rep.extras["device"],
            "rounds": rep.rounds,
            "grad_norms": gn.tolist(),
            "sent_bits": rep.sent_bits.tolist(),
            "cpu_grad_norms_3": rep_cpu.grad_norms.tolist(),
            "cpu_rel_err_3": rel.tolist(),
            "cpu_sent_bits_3": rep_cpu.sent_bits.tolist(),
            "init_time_s": rep.init_time_s,
            "wall_time_s": rep.wall_time_s,
            "ms_per_round": rep.wall_time_s / rep.rounds * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches,
        })
        return rep, launches

    rep, launches = main_path(
        "w8a topk option B hess0=exact rounds<=50 tol=1e-12", spec, "select_topk")
    check(rep.grad_norms[-1] <= rep.grad_norms[0] * 1e-6, f"TopK grad norms {rep.grad_norms}")
    toplek_spec = spec.replace(compressor=CompressorSpec("toplek"))
    rep_le, launches_le = main_path(
        "w8a toplek option B hess0=exact rounds<=50 tol=1e-12", toplek_spec, "select_toplek")
    randseqk_spec = spec.replace(compressor=CompressorSpec("randseqk"), rounds=30, tol=0.0)
    rep_rs, launches_rs = main_path(
        "w8a randseqk option B hess0=exact rounds=30", randseqk_spec, "select_randseqk")
    check(rep_rs.rounds == 30, f"RandSeqK ran {rep_rs.rounds} rounds")

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
    s_round = torch.as_tensor(prng.randint(round_keys[1], 0, t_len), device=dev)
    window = randseqk_window_mask(t_len, k, s_round)
    zeros = torch.zeros_like(delta1)
    randseqk_ms = median_ms({
        "kernel": lambda: select_randseqk_cuda(delta1, k, s_round),
        "plain": lambda: select_randseqk_plain(delta1, k, s_round),
        "library": lambda: torch.where(window, delta1, zeros),
    })
    unif_round = torch.as_tensor(prng.uniform(round_keys[1]), device=dev)
    toplek_ms = median_ms({
        "kernel": lambda: select_toplek_cuda(delta1, k, unif_round),
        "plain": lambda: select_toplek_plain(delta1, k, unif_round),
        "ranking_only": lambda: torch.topk(keys, k, dim=-1),
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
    randseqk_bound = bound(
        n_clients * (k + t_len) * 8 + n_clients * (8 + 4),  # window read, u_hat written, s, sent
        3 * delta1.numel(),  # subtract, wrap, compare per entry
        CUDA_CORE_32BIT_OPS,
    )
    p2 = 1 << (k - 1).bit_length()
    sort_stages = p2.bit_length() * (p2.bit_length() - 1) // 2
    toplek_bound = bound(
        delta1.numel() * 8 * 2 + n_clients * (8 + 4),  # u read, u_hat written, unif, sent
        2 * 33 * delta1.numel() + n_clients * (p2 // 2) * sort_stages * 2,
        CUDA_CORE_32BIT_OPS,
    )
    emit({"phase": "times", "hessian_syrk_packed": syrk_ms, "select_topk": topk_ms,
          "select_randseqk": randseqk_ms, "select_toplek": toplek_ms,
          "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                  f"{CALLS_PER_EVENT} back-to-back calls, the three in turns; "
                  "randseqk library = torch.where on a precomputed window mask; "
                  "toplek has no library call: ranking_only = torch.topk on the "
                  "f32 keys, the ranking part only"})

    # --- 6 where a round's time goes (torch.profiler, 3 rounds), host draws ---
    emit({"phase": "trace", "path": "topk",
          **trace_rounds(make_fednl_round(z, cfg), fednl_init(z, cfg), 3)})
    toplek_cfg = toplek_spec.fednl_config()
    emit({"phase": "trace", "path": "toplek",
          **trace_rounds(make_fednl_round(z, toplek_cfg), fednl_init(z, toplek_cfg), 3)})
    emit({"phase": "draws", **host_draw_ms(prng, upload_draws, n_clients, t_len, dev)})

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
        {
            "name": "select_randseqk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:87",
            "launches": launches_rs["select_randseqk"], "max_abs_err": randseqk_err,
            "ms": randseqk_ms["kernel"], "plain_ms": randseqk_ms["plain"],
            "bound_ms": randseqk_bound[0], "bound_by": randseqk_bound[1],
            "library_ms": randseqk_ms["library"],
        },
        {
            "name": "select_toplek", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:106",
            "launches": launches_le["select_toplek"], "max_abs_err": toplek_err,
            "ms": toplek_ms["kernel"], "plain_ms": toplek_ms["plain"],
            "bound_ms": toplek_bound[0], "bound_by": toplek_bound[1],
            "library_ms": None,
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
