#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: FedNL's round
with the paper's six compressors, FedNL-LS and FedNL-PP, the LM zoo's dense
inference path (granite-3-2b), sweeps (solve_many's batched groups),
sessions (open_session, FNLS1 checkpoints), the wire stack (codecs, frames,
the loopback and TCP star masters) and the topologies above it (trees of
stars, async aggregation, elastic membership, TCP process trees, obs),
the serving engine with its gateway (FedNLServer, GatewayServer), and the
sharded backend over torch.distributed.

    python3 chip_smoke.py

Runs from the root of a checkout; imports ``repro_torch`` from ``src/`` and
nothing of ``repro`` or JAX.  Each phase prints one JSON line; any failure
raises, and the script exits non-zero without the final line.

  1 card     name, count, power limit (nvidia-smi), torch and CUDA versions
  2 build    nvcc of every kernel source, in parallel; seconds and ptxas report
  3 kernels  each kernel against its plain PyTorch version on the card, at the
             shapes of the main paths: SYRK within 1e-13 of max(|Z|^T|h||Z|),
             TopK bit-exact (u_hat bit patterns and sent) on the first rounds'
             corrections, near-ties, the keys-in-device-memory path and edge k;
             RandSeqK bit-exact on the round's real draws, s = 0, s = T-1, a
             wrapping window, k = 1 and k = T; TopLEK exact (u_hat bits and
             kept) on the all-zero round-0 correction, the round-1 correction,
             near-ties, a dyadic fixture, k = 1, k = T and every memory path,
             but for rows where alpha_m* lies within 1e-12 of k/T or unif of p
             (counted; none allowed on the dyadic fixture); flash attention
             within one bf16 ulp (the ulp taken at no less than 2**-14) at
             granite's 32k layer shape, B = 4, a 4096 window, S = 1000, a
             5-token prompt, non-causal 64 x 256 and dh = 128 (the wgmma
             route) and bf16 at dh = 32 (the SIMT route), and within 2e-5 in
             f32 (the SIMT route); each fixture's route checked; the threefry
             kernel bit-exact in f32 and f64 at (142, 45451), T = 1 and one
             client; TopK by keys bit-exact on the round's real uniforms,
             forced ties at the k-th key, k = 1 and k = T
  4 main     repro_torch.api.solve on w8a (Option B, hess0="exact") on the
             card, seven paths, the launch counts set to 0 before each and
             read after it: TopK and TopLEK (tol 1e-12, <= 50 rounds),
             RandSeqK, RandK and Natural (30 rounds), FedNL-LS with TopK (tol
             1e-12, <= 50 rounds), FedNL-PP with TopK and tau = 71 (50
             rounds); launch counts, the grad norm falls, and the first 3
             rounds' grad norms (PP: models), sent_bits, LS's steps and PP's
             clients against the same spec on the CPU (plain versions; the
             same threefry draws)
  5 lm       granite-3-2b at full width: 2 layers (depth cut) on the card
             against the same params on the CPU, prefill B = 2, S = 512 and 4
             decode steps, within LOGIT_ULPS bf16 ulps of the logit scale;
             then 40 layers from seed 0 on the card: make_prefill_step at
             B = 1, S = 32,768 (the repo's prefill_32k shape, its global batch
             of 32 cut to 1), exactly 40 flash launches, all on the wgmma
             route; lm_prefill of a
             5-token prompt against 5 decode steps; ServeEngine with the
             launcher's defaults (6 requests, batch 4, 12 new tokens,
             max_len 128), no kernel launch, the same tokens on a second
             engine and from the launcher
  6 times    CUDA-event medians of each kernel, its plain version and its
             library yardstick at the main paths' shapes, beside the card's
             least time: bytes, or the operations the function needs (threefry:
             the hash's 32-bit operations; flash:
             QK^T and three bf16 P.V products over the visible pairs on the
             bf16 tensor cores); SYRK's ptxas report, dynamic shared memory,
             SASS instruction counts (DMMA, LDGSTS) and the L2 bytes its tile
             schedule stages
  7 trace    one round each of the TopK, RandK and PP paths under
             torch.cuda.set_sync_debug_mode("error") (no host sync: the
             Cholesky solve checks nothing); torch.profiler over 3 rounds of
             the TopK, TopLEK, RandK, Natural and PP paths and over one 32k
             prefill: device time by kernel and the device's busy share of the
             wall time (SYRK's ms per TopK round beside it); the host's ms per
             round for the key split, the clients' keys and draws, and their
             upload
  8 sweep    solve_many of the README's grid at w8a's full shape: 4 seeds x
             {topk, randseqk, natural}, 50 rounds, planned as one batched
             group of 12 specs; the launch counts set to 0 before it and read
             after it: SYRK once a round on 1,704 clients (and at init and in
             the warm-up round), select_topk, select_randseqk and
             threefry_uniform (f64, Natural) once a round each; each spec
             against its own solve() on the card (sent_bits exact every
             round, grad norms within TRAJECTORY_RTOL where >= 1e-10, and
             whether it is bitwise, and op by op where it parts); the
             group's ms per round beside the sum of the 12 solves', peak
             memory, one batched round under
             set_sync_debug_mode("error") and 3 under torch.profiler; then a
             2-spec FedNL-LS group (seeds 0 and 1, TopK, 10 rounds) against
             its solves (ls_steps exact above the Armijo test's rounding
             band, grad norm 1e-7)
  9 session  open_session on w8a TopK: step(3), save, run to 10; the FNLS1
             file restored and run to 10; both equal solve(rounds=10) on the
             card bit for bit (x, grad norms, f, bits); the file round-trips
             byte for byte through load_state and save_state
 10 star     the wire stack: (a) star-loopback at w8a's whole shape, TopK 10
             rounds and TopLEK 3, against the card's local solve, the launch
             counts set to 0 before each and read after: SYRK 142 a round and
             142 at init, the index form of TopK (TopLEK) 142 a round, nothing
             else; grad norms within 1e-8 * norm + 1e-16 where >= 1e-12;
             sent_bits exact, measured payload bits = the analytic bits, frame
             bytes = the wire model; ms per round; (e) a star session: host
             syncs counted over round 2 (set_sync_debug_mode "warn"), saved at
             round 3, stepped and restored runs bit for bit the uninterrupted
             run, the third round traced; (b) each codec's one-row encode at T = 45,451 on the card
             against the CPU's bytes (TopLEK with phase 3's boundary
             allowance); (c) FedNL-PP with RandK over loopback, tau 71,
             FaultSpec(drop_prob=0.2) resampled, 10 rounds: exact launches
             (SYRK, and threefry and TopK by keys' index form three times per
             participant: encode, own decode, the master's PRG replay), the
             participants, drops and bits exactly the CPU run's, its models
             within 1e-8; (d) star-tcp with 8 client processes at w8a's
             per-client width, 5 rounds: bits and bytes exactly loopback's at
             that shape, every child exits 0; the index forms timed at the
             star's one-client shape against their plain and dense forms
 11 topology the topologies at w8a's whole shape, each part's launch counts
             set to 0 before it and read after: (a) an exact tree (fanout 4,
             depth 3: 20 aggregators), TopK, stepped 3, saved and run to 10,
             bit for bit phase 10's flat star (grad norms, f, x, bits, frame
             bytes) with its launches (SYRK 142 a round + 142, the TopK index
             form 142 a round); (a') RandK, 3 rounds, tree and flat star bit
             for bit, threefry and TopK by keys' index form 5 (tree) and 3
             (flat) times per leaf a round; (b) combine="sum" (fanout 12,
             depth 2): x within 1e-12 of the flat star, bits exact, the
             root's AGG bytes; (c) async: staleness 0 bit for bit the flat
             star (5 rounds); staleness 2, max_delay 3, 20 rounds: two card
             runs bit for bit, participants and bits the CPU run's, grad
             norms within 1e-8 * norm + 1e-16, launches one per assignment;
             (d) elastic, clients 130-141 join at round 2 and 0-11 leave at
             round 5: participants and bits the CPU run's, the round-2 delta
             12 uplinks + 12 * T * 64 bits, H_global after the leaves bitwise
             a fresh mean of the survivors' mirrors; (f) the (a), (c) and (d)
             sessions restored from FNLS1 by replay, bit for bit; (e)
             star-tcp: a process tree of 2 aggregators of 4 clients at w8a's
             per-client width, 5 rounds, bit for bit the loopback tree, exit
             codes 0, no cluster live after; (g) obs: a tree round and a
             flat-star round under a live recorder, bit for bit the run
             without it, one comm.hop span per aggregator, UPLINK and AGG
             bytes received against the measured frames, hop times by tree
             level, a profiled tree round
 12 serve    the FedNL serving engine and its gateway at w8a's whole shape,
             on the card: (a) the README grid and a TopLEK tenant (tol
             1e-12) through one FedNLServer(ServeConfig(max_resident=8,
             admit_per_tick=4, max_group=8)), half submitted, 5 ticks, then
             the rest, so that memory pressure spills and resumes tenants;
             the launch counts set to 0 before it and read after it: SYRK =
             admissions (resumes included) + batched rounds, each selection
             kernel and threefry dtype once per tick whose chunk holds its
             branch; each tenant against its own solve() (sent_bits exact,
             TopLEK with phase 3's boundary allowance; grad norms within
             TRAJECTORY_RTOL where >= 1e-10; whether it is bitwise); the
             engine's stats(); (b) one TopK spec alone and in groups of 2, 4
             and 8, against its solve() and across the sizes; (c) evicted at
             round 3 to FNLS1 and resumed in a fresh engine, bit for bit the
             tenant served alone, the file round-tripping byte for byte; (d)
             a star-loopback TopK tenant and a FedNL-PP tenant (tau 71)
             beside a batch group, each bit for bit its own session, exact
             launch counts; (e) a GatewayServer on 127.0.0.1 with the engine
             on the card: a GatewayClient submits 4 specs and streams their
             records (= the reports' bit for bit, each within (a)'s bounds of
             its solve), bad submissions refused naming the field, METRICS
             returning engine.* series, tick latencies; (f) ms per tick and
             tenant-rounds per second of an 8-slot group beside phase 8's
             group, a profiled tick, the state stack and unstack
 13 sharded the sharded backend at w8a's whole shape on a world of one (this
             process, NCCL on the card), each part's launch counts set to 0
             before it and read after: (a) dense_psum, TopK, 10 rounds,
             against the card's local solve: grad norms within 1e-8 * norm
             + 1e-16 where >= 1e-12, sent_elems and the three bit counts
             exact, SYRK once a round (+ the warm-up round and init) and
             select_topk once a round (+ warm-up), nothing else; (b)
             sparse_allgather the same through select_topk_idx, also
             against the CPU run of the port; a round of each under
             set_sync_debug_mode("error"), H^2 - H^1's support equal to
             the CPU's (round 0 changes nothing under hess0="exact"), 3
             rounds of each under torch.profiler; (c) RandSeqK and RandK
             under sparse_allgather, 3 rounds, against the CPU: every
             client's index set every round, bits, grad norms, launches
             (RandK: f32 threefry and TopK by keys' index form once a
             round); (d) a sparse_allgather session stepped 3, saved,
             restored, run to 10, bit for bit (b)'s run, its FNLS1 file
             byte-stable and resumed on the CPU; select_topk_idx at (142, T)
             against its plain version, timed; ms per round beside local's;
             sharded_uplink_bits and each collective's bytes per rank (at a
             world of one a copy on the card: the port's path, not a
             network)
Phase 3 also checks a window without causality through
``models.layers.chunked_attention`` (S = 2,048, q_chunk 512, window 300:
one launch per query chunk on its key slice) on both flash routes, bf16 at
head_dim 128 on wgmma and f32 at head_dim 32 on SIMT, against the plain
version on the same chunks and offsets.
Then the kernels line, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA's data sheet for the H100 SXM at 700 W (dense): the least time the
# card could take is max(bytes / HBM rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12  # FP64 on the tensor cores
CUDA_CORE_32BIT_OPS = 67e12  # 32-bit ops outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # bf16 on the tensor cores
# exp2 on the MUFU pipe: 16 results per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132 SMs at
# the 1,980 MHz boost clock of the H100 SXM
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
# the integer work TopK's function needs per key: the f32 key, four radix
# passes of a digit, a compare and a count, and the final compare
SELECT_OPS_PER_KEY = 14
# the 32-bit operations threefry's function needs per element: the key's two
# additions, 20 rounds of add, rotate and xor, 5 key injections of two adds,
# and 4 to make the float from the bits
THREEFRY_OPS_PER_ELEM = 2 + 20 * 3 + 5 * 2 + 4
PP_TAU = 71  # FedNL-PP's participants per round at w8a: half the 142 clients

SYRK_TOL = 1e-13  # of max(|Z|^T |h| |Z|): FP64 sums of n_i = 348 terms, any order
TRAJECTORY_RTOL = 1e-8  # card vs CPU grad norms over the first 3 rounds
TOPLEK_BOUNDARY = 1e-12  # TopLEK's allowed difference: alpha_m* this near k/T, or unif near p
DRAW_REPS = 200  # host draw timing: rounds of draws averaged
TIMED_REPS = 21  # event pairs per function; the median is reported
CALLS_PER_EVENT = 10
FLASH_TIMED_REPS = 5  # at the 32k prefill shape: one call per event pair
FLASH_F32_ATOL = 2e-5  # f32 flash against its plain version (the JAX package's own bound)
# card vs CPU logits of the 2-layer cut, in bf16 ulps of the logit scale (the
# largest |logit|): bf16 activations rounded after differently ordered sums
LOGIT_ULPS = 4
# the 40-layer prefill against 40-layer sequential decode on the card: the same
# rounding differences, compounded over 40 residual updates
DEPTH_LOGIT_ULPS = 8
LM_CUT_LAYERS = 2  # the card-vs-CPU check's depth cut (granite has 40)
PREFILL_SEQ = 32768  # launch/specs.py prefill_32k; its global batch of 32 cut to 1
SWEEP_ROUNDS = 50  # the README's sweep: ExperimentSpec(..., rounds=50).grid(...)
SWEEP_GN_FLOOR = 1e-10  # group vs solve() grad norms compared where the solve's is above
LS_GROUP_ROUNDS = 10
# FedNL-LS's Armijo test is decided by rounding below this grad norm
# (ROADMAP C6): the group's ls_steps are held exact to its solve()'s above it
LS_EXACT_FLOOR = 1e-7
SESSION_ROUNDS, SESSION_SAVE_AT = 10, 3
STAR_ROUNDS = 10  # phase 10: star-loopback TopK at w8a, and its local solve
STAR_LEK_ROUNDS = 3  # phase 10: the star-loopback TopLEK path
STAR_GN_FLOOR = 1e-12  # star vs local grad norms compared where local's is above
# ... within TRAJECTORY_RTOL * norm + STAR_GN_ATOL: a star client's one-client
# batch and the local round's 142-client batch give the GEMVs of the oracles
# other last bits (cuBLAS picks by batch), and once Newton's convergence is
# quadratic, an ulp of x stays an absolute error of ~1e-20..1e-16 in the grad
# norm while the norm itself shrinks toward 1e-14
STAR_GN_ATOL = 1e-16
STAR_PP_DROP = 0.2  # phase 10 (c): FaultSpec(drop_prob=...) of the PP star
TCP_SHAPE = (301, 8, 348)  # phase 10 (d): w8a's d and n_i, 8 clients (DataSpec.shape order)
TCP_ROUNDS = 5
# phase 11: the topologies at w8a
TREE_ROUNDS = 10  # (a) the exact tree, TopK; (b) the sum tree
TREE_RANDK_ROUNDS = 3  # (a') the exact tree, RandK
ASYNC_SYNC_ROUNDS = 5  # (c) staleness 0 against the flat star
ASYNC_ROUNDS = 20  # (c) staleness 2, max_delay 3
ELASTIC_ROUNDS = 10  # (d)
ELASTIC_JOIN_AT, ELASTIC_LEAVE_AT = 2, 5
ELASTIC_JOINERS, ELASTIC_LEAVERS = range(130, 142), range(0, 12)
SUM_TREE_RTOL = SUM_TREE_ATOL = 1e-12  # (b) x against the flat star (the reference's bound)
# phase 12: the serving engine and its gateway at w8a
SERVE_ROUNDS = 50  # (a) the README grid's rounds
SERVE_CONFIG = {"max_resident": 8, "admit_per_tick": 4, "max_group": 8}  # (a): pressure
SERVE_EARLY, SERVE_EARLY_TICKS = 6, 5  # (a) tenants submitted first, ticks before the rest
GROUP_SIZES, GROUP_ROUNDS = (1, 2, 4, 8), 10  # (b)
EVICT_ROUNDS, EVICT_AT = 10, 3  # (c)
SOLO_STAR_ROUNDS, SOLO_PP_ROUNDS = 3, 5  # (d)
GATEWAY_ROUNDS = 20  # (e)
TICK_REPS = 10  # (f) ticks timed of an 8-slot group
# phase 13: the sharded backend at w8a, a world of one
SHARDED_ROUNDS = 10  # (a) dense_psum, (b) sparse_allgather, (d) the session
SHARDED_RANDOM_ROUNDS = 3  # (c) RandSeqK and RandK under sparse_allgather


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


def launch_counts(ops) -> dict[str, int]:
    """Each kernel's launches since the last reset; threefry's also by dtype
    (``threefry_uniform_float32``/``_float64``), as its wrapper counts them."""
    by_dtype = ops.threefry.threefry_uniform_cuda.dtype_launches
    return {**ops.launch_counts(), **{f"threefry_uniform_{k}": v for k, v in by_dtype.items()}}


def bits_equal(a, b) -> bool:
    """Bit-for-bit equality of two float64 tensors (+0.0 and -0.0 differ)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def median_ms(fns: dict, reps: int = TIMED_REPS, calls: int = CALLS_PER_EVENT) -> dict[str, float]:
    """Device ms per call of each function: CUDA events around ``calls``
    back-to-back calls (so the queue runs ahead of the host and the host's
    launch cost hides behind the device's work where it can), median over
    ``reps`` such pairs, the functions in turns."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {
        name: statistics.median(s.elapsed_time(e) for s, e in pairs) / calls
        for name, pairs in events.items()
    }


def trace(step, n: int, unit: str) -> dict:
    """Device time by kernel over ``n`` calls of ``step`` (warmed up by the
    caller), and the device's busy share of the host's wall time over the
    window (the profiler's own host cost included, so the share is a floor)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        return {f"{unit}s": n, "device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        f"{unit}s": n,
        f"wall_ms_per_{unit}": wall_us / n / 1e3,
        f"device_ms_per_{unit}": device_us / n / 1e3,
        "device_busy_share": device_us / wall_us,
        f"kernel_launches_per_{unit}": sum(e.count for e in kernels) / n,
        "top_kernels": [
            {"name": e.key[:90], f"ms_per_{unit}": e.self_device_time_total / n / 1e3,
             f"calls_per_{unit}": e.count / n}
            for e in top
        ],
    }


def trace_rounds(round_fn, state, rounds: int) -> dict:
    """``trace`` over ``rounds`` FedNL rounds after one warm-up round."""
    box = [round_fn(state)[0]]

    def step():
        box[0] = round_fn(box[0])[0]

    return trace(step, rounds, "round")


def bound(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def syrk_build_facts(build, report: str | None) -> dict:
    """The SYRK kernel as built: ptxas's registers, spills and shared memory
    (from this run's build; "not measured" when the library was built before
    the run), its dynamic shared memory, and the instructions its SASS holds
    (cuobjdump beside nvcc): DMMA, the tensor-core FP64 product; LDGSTS, the
    cp.async copy; DFMA, a product on the FP64 pipes."""
    import ctypes

    facts = {"dynamic_smem_bytes": build.function(
        "hessian_syrk", "syrk_packed_smem_bytes", (), restype=ctypes.c_int)()}
    if report is None:
        facts["ptxas"] = "not measured (library built before this run)"
    else:
        facts["ptxas"] = [ln.strip() for ln in report.splitlines()
                          if "registers" in ln or "spill" in ln or "smem" in ln]
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        facts["sass"] = "not measured (no cuobjdump beside nvcc)"
        return facts
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("hessian_syrk"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = [ln.split(";")[0].split("*/")[-1].strip() for ln in sass.splitlines() if "/*" in ln]
    opcode = [op.split()[1] if op.startswith("@") else op.split()[0] for op in ops if op]
    facts["sass"] = {name: sum(o.startswith(name) for o in opcode)
                     for name in ("DMMA", "LDGSTS", "DFMA", "DMUL")}
    facts["sass"]["dmma_shapes"] = sorted({o for o in opcode if o.startswith("DMMA")})
    return facts


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


def flash_inputs(dev, b, sq, sk, h, kv, dh, dtype, seed):
    """q (b, sq, h, dh), k and v (b, sk, kv, dh): standard normal draws of a
    torch generator on the card, rounded to ``dtype``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


def check_flash(dev, tfa) -> tuple[dict, float]:
    """The flash kernel against its plain version on the card: bf16 within
    one bf16 ulp (taken at no less than BF16_ULP_FLOOR), f32 within
    FLASH_F32_ATOL.  Returns the per-case report and the largest absolute
    error over the bf16 cases."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {  # name: (b, sq, sk, h, kv, dh, causal, window, dtype)
        "granite_32k_layer": (1, PREFILL_SEQ, PREFILL_SEQ, 32, 8, 64, True, None, bf16),
        "b4_s4096": (4, 4096, 4096, 32, 8, 64, True, None, bf16),
        "s8192_window4096": (1, 8192, 8192, 32, 8, 64, True, 4096, bf16),
        "s1000_padding": (1, 1000, 1000, 32, 8, 64, True, None, bf16),
        "prompt_sq5": (1, 5, 5, 32, 8, 64, True, None, bf16),
        "noncausal_64x256": (1, 64, 256, 32, 8, 64, False, None, bf16),
        "dh128_window200": (2, 777, 777, 8, 2, 128, True, 200, bf16),
        "dh32_simt_route": (2, 1000, 1000, 8, 2, 32, True, 300, bf16),
        "f32_s2048": (2, 2048, 2048, 32, 8, 64, True, None, f32),
    }
    report, max_err = {}, 0.0
    for seed, (name, (b, sq, sk, h, kv, dh, causal, window, dtype)) in enumerate(cases.items()):
        q, k, v = flash_inputs(dev, b, sq, sk, h, kv, dh, dtype, 100 + seed)
        routes = dict(tfa.flash_attention_cuda.route_launches)
        got = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        route = tfa.flash_route(dtype, dh)
        routes[route] += 1
        check(tfa.flash_attention_cuda.route_launches == routes, f"flash {name}: not one {route} launch")
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == dtype, f"flash {name}: {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash {name}: output not finite")
        err = float((got.float() - want.float()).abs().max())
        row = {"shape": [b, sq, sk, h, kv, dh], "causal": causal, "window": window,
               "dtype": str(dtype), "route": route, "max_abs_err": err}
        if dtype == f32:
            check(err <= FLASH_F32_ATOL, f"flash {name}: f32 error {err} > {FLASH_F32_ATOL}")
        else:
            ulps = tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR)
            pure = tfa.bf16_ulps(got, want)
            row.update(max_ulps=float(ulps.max()), ulp_floor=tfa.BF16_ULP_FLOOR,
                       beyond_1_ulp_without_floor=int((pure > 1).sum()),
                       differing=int((got != want).sum()), elements=got.numel())
            check(float(ulps.max()) <= 1.0, f"flash {name}: {float(ulps.max())} bf16 ulps")
            max_err = max(max_err, err)
        report[name] = row
        del q, k, v, got, want
    # a window without causality through models.layers.chunked_attention
    # (ROADMAP C4): one launch per query chunk on the reference's key slice
    # of the chunk, its offsets passed to the kernel, against the plain
    # version on the same chunks and offsets
    from repro_torch.models import layers

    chunked = {  # name: (b, s, h, kv, dh, dtype)
        "noncausal_window300_qchunk512_wgmma": (1, 2048, 8, 2, 128, bf16),
        "noncausal_window300_qchunk512_simt_f32": (2, 2048, 8, 2, 32, f32),
    }
    for seed, (name, (b, s, h, kv, dh, dtype)) in enumerate(chunked.items()):
        q, k, v = flash_inputs(dev, b, s, s, h, kv, dh, dtype, 200 + seed)
        slices = layers.window_slices(s, s, 300, 512)
        route = tfa.flash_route(dtype, dh)
        routes = dict(tfa.flash_attention_cuda.route_launches)
        got = layers.chunked_attention(q, k, v, causal=False, window=300, q_chunk=512)
        routes[route] += len(slices)
        check(tfa.flash_attention_cuda.route_launches == routes,
              f"flash {name}: not {len(slices)} {route} launches")
        want = torch.cat([
            tfa.flash_attention_plain(q[:, q0:q0 + n], k[:, k0:k0 + span], v[:, k0:k0 + span],
                                      causal=False, window=300, q_offset=q0, k_offset=k0)
            for q0, n, k0, span in slices], dim=1)
        torch.cuda.synchronize()
        check(got.shape == q.shape and bool(torch.isfinite(got).all()), f"flash {name}: output")
        err = float((got.float() - want.float()).abs().max())
        row = {"shape": [b, s, s, h, kv, dh], "causal": False, "window": 300, "q_chunk": 512,
               "slices": [list(sl) for sl in slices], "dtype": str(dtype), "route": route,
               "launches": len(slices), "max_abs_err": err}
        if dtype == f32:
            check(err <= FLASH_F32_ATOL, f"flash {name}: f32 error {err} > {FLASH_F32_ATOL}")
        else:
            ulps = tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR)
            row.update(max_ulps=float(ulps.max()), ulp_floor=tfa.BF16_ULP_FLOOR)
            check(float(ulps.max()) <= 1.0, f"flash {name}: {float(ulps.max())} bf16 ulps")
            max_err = max(max_err, err)
        report[name] = row
        del q, k, v, got, want
    return report, max_err


def bf16_ulp_at(scale: float) -> float:
    """The bf16 spacing at magnitude ``scale``: 2**(e - 8) for [2**(e-1), 2**e)."""
    return 2.0 ** (math.frexp(scale)[1] - 8)


def logit_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the logit scale (the largest |want|)."""
    return float((got.float() - want.float()).abs().max()) / bf16_ulp_at(
        float(want.float().abs().max()))


def argmax_rows(got, want, ulps: int) -> tuple[int, int, float]:
    """Rows of (rows, vocab) logits whose argmax agrees, rows whose argmax
    differs where the reference's top-2 margin is at least ``ulps`` bf16 ulps
    of the logit scale (none allowed: a greedy token may differ only at a
    near tie), and the smallest top-2 margin of the reference."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    top2 = w.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = g.argmax(-1) == w.argmax(-1)
    tol = ulps * bf16_ulp_at(float(w.abs().max()))
    return int(same.sum()), int((~same & (margin >= tol)).sum()), float(margin.min())


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def lm_phase(dev, ops) -> dict:
    """granite-3-2b at full width: the 2-layer card-vs-CPU check, then the
    40-layer prefill, prefill against decode, and the serving engine.
    Returns what the later phases need."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import init_decode_cache, init_lm_params, lm_decode_step, lm_prefill
    from repro_torch.models.lm import padded_vocab
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.train import make_prefill_step

    full = get_config("granite-3-2b")
    vp = padded_vocab(full)
    rng = np.random.default_rng(13)
    no_launch = {name: 0 for name in ops.launch_counts()}

    # 1 the same params on the card and on the CPU, 2 layers
    cut = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)
    p_cpu = init_lm_params(0, cut, "cpu")
    p_card = tree_to(p_cpu, dev)
    toks = rng.integers(0, full.vocab, size=(2, 512))
    card = lm_prefill(p_card, cut, torch.as_tensor(toks, device=dev)).cpu()
    host = lm_prefill(p_cpu, cut, torch.as_tensor(toks))
    prefill_ulps = logit_ulps(card, host)
    check(prefill_ulps <= LOGIT_ULPS, f"lm 2-layer prefill: card vs CPU {prefill_ulps} ulps")
    argmax = [argmax_rows(card, host, LOGIT_ULPS)]
    c_card, c_cpu = init_decode_cache(cut, 2, 8, dev), init_decode_cache(cut, 2, 8, "cpu")
    decode_ulps = []
    for s in range(4):
        t = toks[:, s : s + 1]
        lg_card, c_card = lm_decode_step(p_card, cut, c_card, torch.as_tensor(t, device=dev))
        lg_cpu, c_cpu = lm_decode_step(p_cpu, cut, c_cpu, torch.as_tensor(t))
        decode_ulps.append(logit_ulps(lg_card.cpu(), lg_cpu))
        argmax.append(argmax_rows(lg_card.cpu(), lg_cpu, LOGIT_ULPS))
    check(max(decode_ulps) <= LOGIT_ULPS, f"lm 2-layer decode: card vs CPU {decode_ulps} ulps")
    check(all(bad == 0 for _, bad, _ in argmax),
          f"lm 2-layer: an argmax differs away from a near tie: {argmax}")
    emit({
        "phase": "lm", "part": "card_vs_cpu", "arch": full.name,
        "cut": f"n_layers {LM_CUT_LAYERS} of {full.n_layers}; full width",
        "prefill_batch_seq": [2, 512], "prefill_logit_ulps": prefill_ulps,
        "prefill_logit_scale": float(host.float().abs().max()),
        "decode_logit_ulps": decode_ulps,
        "argmax_same_of_2": [a for a, _, _ in argmax], "min_top2_margin": [m for _, _, m in argmax],
        "tol_ulps": LOGIT_ULPS,
        "bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    })
    del p_cpu, p_card, c_card, c_cpu

    # 2 forty layers, initialised on the card
    t0 = time.perf_counter()
    params = init_lm_params(0, full, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill_step(full)
    batch = {"tokens": torch.as_tensor(rng.integers(0, full.vocab, size=(1, PREFILL_SEQ)), device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = dict(ops.flash_attention_mod.flash_attention_cuda.route_launches)
    check(launches == {**no_launch, "flash_attention": full.n_layers},
          f"32k prefill launches {launches}, want {full.n_layers} flash launches")
    check(routes == {"wgmma": full.n_layers, "simt": 0},
          f"32k prefill flash routes {routes}, want all {full.n_layers} on wgmma")
    check(logits.shape == (1, vp) and bool(torch.isfinite(logits).all()), "32k prefill logits")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit({
        "phase": "lm", "part": "prefill_32k", "arch": full.name, "n_layers": full.n_layers,
        "params": n_params, "param_bytes_f32": n_params * 4, "init_s": init_s,
        "batch_seq": [1, PREFILL_SEQ], "cut": "global batch 32 of prefill_32k cut to 1",
        "first_call_ms": first_s * 1e3, "ms": steady_s * 1e3,
        "tokens_per_s": PREFILL_SEQ / steady_s, "max_memory_allocated": peak,
        "launches": launches, "flash_routes": routes,
        "logit_scale": float(logits.float().abs().max()),
    })

    # prefill (the kernel) against sequential decode (plain einsum), 40 layers
    prompt = torch.as_tensor(rng.integers(0, full.vocab, size=(1, 5)), device=dev)
    want = lm_prefill(params, full, prompt)
    cache = init_decode_cache(full, 1, 8, dev)
    for s in range(5):
        got, cache = lm_decode_step(params, full, cache, prompt[:, s : s + 1])
    got = got[:, 0]
    depth_ulps = logit_ulps(got, want)
    same, bad, margin = argmax_rows(got, want, DEPTH_LOGIT_ULPS)
    check(depth_ulps <= DEPTH_LOGIT_ULPS, f"prefill vs decode: {depth_ulps} ulps")
    check(bad == 0, f"prefill vs decode: argmax differs at top-2 margin {margin}")
    emit({"phase": "lm", "part": "prefill_vs_decode", "prompt_len": 5,
          "logit_ulps": depth_ulps, "tol_ulps": DEPTH_LOGIT_ULPS, "argmax_same": bool(same),
          "top2_margin": margin})
    del cache, got, want

    # the serving engine with the launcher's defaults
    def requests():
        return [Request(prompt=[(r * 7 + i) % full.vocab for i in range(5)], max_new_tokens=12)
                for r in range(6)]

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(params, full, batch_size=4, max_len=128, device=dev)
        for r in requests():
            engine.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine_launches = ops.launch_counts()
        check(engine_launches == no_launch, f"serving launched kernels: {engine_launches}")
        check(len(done) == 6 and all(r.done and len(r.generated) == 12 for r in done),
              "serving: not every request done with 12 tokens")
        runs.append({"tokens": [r.generated for r in done], "wall_s": wall, "steps": engine.steps,
                     "peak": torch.cuda.max_memory_allocated()})
        del engine
    check(runs[0]["tokens"] == runs[1]["tokens"], "serving: a second engine gave other tokens")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launched = serve_launcher.main(["--arch", full.name, "--device", str(dev)])
    check([r.generated for r in launched] == runs[0]["tokens"],
          "the launcher's tokens differ from the engine's (same seed, same card)")
    total = sum(len(t) for t in runs[0]["tokens"])
    emit({
        "phase": "lm", "part": "serve", "requests": 6, "batch": 4, "new_tokens": 12,
        "max_len": 128, "steps": runs[0]["steps"], "tokens": total,
        "wall_s": [r["wall_s"] for r in runs],
        "ms_per_step": [r["wall_s"] / r["steps"] * 1e3 for r in runs],
        "tokens_per_s": [total / r["wall_s"] for r in runs],
        "max_memory_allocated": [r["peak"] for r in runs], "launches": no_launch,
        "first_tokens": runs[0]["tokens"][:2], "launcher": out.getvalue().strip().splitlines()[0],
    })
    return {"cfg": full, "params": params, "prefill": prefill, "batch": batch, "launches": launches,
            "flash_routes": routes}


def _reports_bitwise(got, want) -> bool:
    """Two RunReports of one spec agree bit for bit: grad norms, f, x, bits."""
    return (
        got.rounds == want.rounds
        and [g.hex() for g in got.grad_norms] == [g.hex() for g in want.grad_norms]
        and [r.f for r in got.records] == [r.f for r in want.records]
        and bool(np.array_equal(got.x, want.x))
        and list(got.sent_bits) == list(want.sent_bits)
        and list(got.sent_bits_wire) == list(want.sent_bits_wire)
    )


def _group_against_solves(label: str, rep, specs, z_np, solve) -> dict:
    """Each spec of a batched group against its own solve() on the card:
    sent_bits exact every round, grad norms within TRAJECTORY_RTOL where the
    solve's is >= SWEEP_GN_FLOOR, ls_steps exact; whether each is bitwise."""
    out = {"bitwise": [], "max_rel_gn": 0.0, "max_rel_x": 0.0, "seq_ms_per_round": []}
    for spec, got in zip(specs, rep.reports):
        want = solve(spec, z=z_np)
        name = f"{label} seed={spec.seed} {spec.compressor.name}"
        check(got.extras.get("sweep_batched") is True, f"{name}: not batched")
        check(got.rounds == want.rounds == spec.rounds, f"{name}: rounds {got.rounds}")
        check(list(got.sent_bits) == list(want.sent_bits), f"{name}: sent_bits differ")
        check(bool(np.all(np.isfinite(got.x))) and got.x.shape == want.x.shape, f"{name}: x")
        live = want.grad_norms >= SWEEP_GN_FLOOR
        rel = np.abs(got.grad_norms[live] - want.grad_norms[live]) / want.grad_norms[live]
        check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{name}: grad norms differ: {rel.max()}")
        if spec.algorithm == "fednl-ls":
            # exact above the Armijo test's rounding band (ROADMAP C6)
            band = want.grad_norms < LS_EXACT_FLOOR
            differ = [r for r in range(want.rounds) if got.ls_steps[r] != want.ls_steps[r]]
            check(all(band[r] for r in differ), f"{name}: ls_steps differ at rounds {differ}")
            out.setdefault("ls_steps_differ_in_band", []).append(differ)
        out["bitwise"].append(_reports_bitwise(got, want))
        out["max_rel_gn"] = max(out["max_rel_gn"], float(rel.max()) if rel.size else 0.0)
        out["max_rel_x"] = max(out["max_rel_x"], float(
            np.max(np.abs(got.x - want.x)) / np.max(np.abs(want.x))))
        out["seq_ms_per_round"].append(want.wall_time_s / want.rounds * 1e3)
    return out


def where_group_parts(group, z) -> dict:
    """Where a batched group parts, bit for bit, from the sequential rounds:
    spec by spec, the group's state after init and after each of two rounds
    against the sequential round's, then each op of the round from the same
    inputs (the sequential run's state) as the batched round computes it,
    against the op on the spec's lone tensors as its own round computes it:
    the client oracles (f, grad, the SYRK rows), the clients' Frobenius
    norms, the means over clients, the grad norm, the master's Cholesky
    factor and solve."""
    import torch

    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.core.fednl_batch import _aligned, _client_frob_norms, batch_oracles
    from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, unpack_triu
    from repro_torch.objectives.logreg import logreg_oracles_packed

    n, _, d = z.shape
    specs = group.specs
    lam = specs[0].lam
    count = len(specs)
    out = {"specs": [f"seed={spec.seed} {spec.compressor.name}" for spec in specs]}
    seq = [fednl_init(z, spec.fednl_config(), seed=spec.seed) for spec in specs]
    out["init_h_local"] = [bits_equal(group.state.h_local[s], seq[s].h_local) for s in range(count)]
    rounds = [make_fednl_round(z, spec.fednl_config()) for spec in specs]
    state = group.state
    for r in range(2):
        state, _ = group.round_fn(state)
        seq = [rounds[s](seq[s])[0] for s in range(count)]
        out[f"round{r}_x"] = [bits_equal(state.x[s], seq[s].x) for s in range(count)]
        out[f"round{r}_h_global"] = [bits_equal(state.h_global[s], seq[s].h_global)
                                     for s in range(count)]
    f_b, grad_b, hess_b = batch_oracles(z, torch.stack([st.x for st in seq]), lam, True)
    delta_b = hess_b - torch.stack([st.h_local for st in seq]).view(count * n, -1)
    one = [logreg_oracles_packed(z, st.x, lam) for st in seq]  # lone tensors, as solve() has
    g_lone = [torch.mean(o[1], dim=0) for o in one]
    grads = torch.stack(g_lone)
    eye = torch.eye(d, dtype=torch.float64, device=z.device)
    h_lone = [unpack_triu(st.h_global, d) + lam * eye for st in seq]
    h = torch.stack(h_lone)
    h_local = torch.stack([st.h_local for st in seq])
    checks = {
        "oracle_f": lambda s: bits_equal(f_b[s], one[s][0]),
        "oracle_grad": lambda s: bits_equal(grad_b[s], one[s][1]),
        "oracle_syrk_rows": lambda s: bits_equal(hess_b[s * n:(s + 1) * n], one[s][2]),
        "client_frob_norms": lambda s: bits_equal(
            _client_frob_norms(delta_b, count, d)[s],
            frob_norm_from_packed(one[s][2] - seq[s].h_local, d)),
        "mean_grad_over_clients": lambda s: bits_equal(
            torch.mean(grad_b, dim=1)[s], torch.mean(one[s][1], dim=0)),
        "mean_f_over_clients": lambda s: bits_equal(
            torch.mean(_aligned(f_b), dim=1)[s], torch.mean(one[s][0])),
        "mean_h_over_clients": lambda s: bits_equal(
            torch.mean(h_local, dim=1)[s], torch.mean(seq[s].h_local, dim=0)),
        "grad_norm": lambda s: bits_equal(
            torch.linalg.vector_norm(_aligned(grads), dim=-1)[s],
            torch.linalg.vector_norm(g_lone[s])),
        "cholesky_factor": lambda s: bits_equal(
            torch.linalg.cholesky_ex(h)[0][s], torch.linalg.cholesky_ex(h_lone[s])[0]),
        "cholesky_solve": lambda s: bits_equal(
            cholesky_solve(h, grads)[s], cholesky_solve(h_lone[s], g_lone[s])),
    }
    for name, fn in checks.items():
        out[name] = [fn(s) for s in range(count)]
    return out


def slot_alignment(z, x, h_local, lam: float, count: int = 12) -> dict:
    """Whether an op of the batched round gives a spec bits that depend on
    its slot: one spec's inputs stacked in ``count`` slots, each slot's
    result against slot 0's and against the op on the lone tensor (a fresh
    allocation, as in the spec's own round), on the stacked rows as they lie
    ("raw": a spec's block starts s * size elements in) and as
    ``fednl_batch._aligned`` lays them (each block on a 32-byte boundary).
    Returns, per op, the slots that differ."""
    import torch

    from repro_torch.core.fednl_batch import _aligned, _client_frob_norms
    from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, unpack_triu
    from repro_torch.objectives.logreg import _matvec, _softplus, logreg_oracles_packed

    n, _, d = z.shape
    f_c, g_c, hess = logreg_oracles_packed(z, x, lam)
    g = torch.mean(g_c, dim=0)
    delta = hess - h_local
    soft = _softplus(-_matvec(z, x))
    h = unpack_triu(torch.mean(h_local, dim=0), d) + lam * torch.eye(
        d, dtype=torch.float64, device=z.device)

    def stack(v):
        return v.repeat(count, *([1] * v.ndim))

    ops = {  # name: (raw, aligned or None, lone)
        f"mean_over_clients ({count}, {n})": (
            lambda: torch.mean(stack(f_c), dim=1),
            lambda: torch.mean(_aligned(stack(f_c)), dim=1), torch.mean(f_c)),
        f"mean_over_samples ({count}, {n}, {soft.shape[-1]})": (
            lambda: torch.mean(stack(soft), dim=-1),
            lambda: torch.mean(_aligned(stack(soft)), dim=-1), torch.mean(soft, dim=-1)),
        f"sum_of_squares ({count}, {d})": (
            lambda: torch.sum(stack(x * x), dim=-1),
            lambda: torch.sum(_aligned(stack(x * x)), dim=-1), torch.sum(x * x)),
        f"vector_norm ({count}, {d})": (
            lambda: torch.linalg.vector_norm(stack(g), dim=-1),
            lambda: torch.linalg.vector_norm(_aligned(stack(g)), dim=-1),
            torch.linalg.vector_norm(g)),
        f"client_frob_norms ({count} x {n}, {delta.shape[-1]})": (
            lambda: frob_norm_from_packed(stack(delta).view(count * n, -1), d).view(count, n),
            lambda: _client_frob_norms(stack(delta).view(count * n, -1), count, d),
            frob_norm_from_packed(delta, d)),
        f"mean_over_clients_of_grads ({count}, {n}, {d})": (
            lambda: torch.mean(stack(g_c), dim=1), None, g),
        f"cholesky_factor ({count}, {d}, {d})": (
            lambda: torch.linalg.cholesky_ex(stack(h))[0], None, torch.linalg.cholesky_ex(h)[0]),
        f"cholesky_solve ({count}, {d}, {d})": (
            lambda: cholesky_solve(stack(h), stack(g)), None, cholesky_solve(h, g)),
    }
    out = {}
    for name, (raw_fn, aligned_fn, lone) in ops.items():
        row = {}
        for layout, fn in (("raw", raw_fn), ("aligned", aligned_fn)):
            if fn is None:
                continue
            got = fn()
            row[f"{layout}_slots_not_slot0"] = [
                s for s in range(count) if not bits_equal(got[s], got[0])]
            row[f"{layout}_slots_not_lone"] = [
                s for s in range(count) if not bits_equal(got[s], lone)]
        out[name] = row
    return out


def sweep_phase(ops) -> dict:
    """Phase 8: the README's 4 seeds x {topk, randseqk, natural} grid at w8a
    through solve_many, one batched group; then a 2-spec FedNL-LS group."""
    import torch

    from repro_torch.api import DataSpec, ExperimentSpec, solve, solve_many
    from repro_torch.api.batch import make_group, plan_sweep

    base = ExperimentSpec(data=DataSpec(dataset="w8a", seed=0), rounds=SWEEP_ROUNDS)
    sweep = base.grid(seed=range(4), compressor=["topk", "randseqk", "natural"])
    specs = sweep.specs()
    plans, _ = plan_sweep(specs, sweep.batch)
    check([(p.kind, len(p.indices)) for p in plans] == [("batch", 12)],
          f"the README grid plans as {[(p.kind, p.indices) for p in plans]}")
    z_np = base.data.build()
    n_clients = z_np.shape[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = solve_many(sweep)
    launches = launch_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update(select_topk=SWEEP_ROUNDS + 1, select_randseqk=SWEEP_ROUNDS + 1,
                threefry_uniform=SWEEP_ROUNDS + 1, threefry_uniform_float64=SWEEP_ROUNDS + 1,
                hessian_syrk_packed=SWEEP_ROUNDS + 2)
    check(launches == want, f"sweep launches {launches}, want {want}")
    check(len(rep.log) == 1 and rep.log[0].startswith("batched 12 specs as one group")
          and f"{12 * n_clients} clients a SYRK launch" in rep.log[0], f"sweep log {rep.log}")
    check(rep.extras["batched_specs"] == 12, f"sweep extras {rep.extras}")
    group_ms = rep.reports[0].extras["batch_wall_time_s"] / SWEEP_ROUNDS * 1e3
    against = _group_against_solves("sweep", rep, specs, z_np, solve)

    # one batched round without a host sync, and 3 under the profiler
    z = torch.as_tensor(z_np, dtype=torch.float64, device="cuda").contiguous()
    group = make_group(specs, z)
    warm, _ = group.round_fn(group.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        group.round_fn(warm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    group_trace = trace_rounds(group.round_fn, group.state, 3)
    slots = slot_alignment(z, warm.x[0], warm.h_local[0], specs[0].lam)
    parts = where_group_parts(group, z)
    emit({"phase": "sweep", "part": "where_the_group_parts", "slot_alignment": slots,
          "bitwise_by_op": parts})
    by_slot = {name: row["aligned_slots_not_slot0"] for name, row in slots.items()
               if row.get("aligned_slots_not_slot0")}
    check(not by_slot, f"rows laid from 32-byte boundaries still differ by slot: {by_slot}")
    # TopK draws nothing, so its four seeds compute one trajectory: in
    # slots 0-3 of the group they must agree bit for bit
    topk = [r for spec, r in zip(specs, rep.reports) if spec.compressor.name == "topk"]
    check(len(topk) == 4 and all(_reports_bitwise(r, topk[0]) for r in topk),
          "the group's TopK specs differ by slot")
    del group, warm, z

    ls_specs = base.replace(algorithm="fednl-ls", rounds=LS_GROUP_ROUNDS).grid(seed=[0, 1]).specs()
    ops.reset_launch_counts()
    rep_ls = solve_many(ls_specs)
    ls_launches = launch_counts(ops)
    check(rep_ls.extras["batched_specs"] == 2, f"LS group log {rep_ls.log}")
    check(ls_launches["hessian_syrk_packed"] == LS_GROUP_ROUNDS + 2
          and ls_launches["select_topk"] == LS_GROUP_ROUNDS + 1, f"LS launches {ls_launches}")
    ls_against = _group_against_solves("ls", rep_ls, ls_specs, z_np, solve)
    check(_reports_bitwise(rep_ls.reports[1], rep_ls.reports[0]),
          "the LS group's two TopK specs differ by slot")

    out = {
        "phase": "sweep", "grid": "w8a seed=range(4) x compressor=[topk, randseqk, natural]",
        "specs": len(specs), "rounds": SWEEP_ROUNDS, "clients_per_syrk_launch": 12 * n_clients,
        "log": rep.log, "launches": launches,
        "group_ms_per_round": group_ms,
        "sequential_ms_per_round_sum": sum(against["seq_ms_per_round"]),
        "sequential_ms_per_round": against["seq_ms_per_round"],
        "group_init_s": rep.reports[0].extras["batch_init_time_s"],
        "peak_memory_bytes": peak,
        "bitwise_vs_solve": against["bitwise"],
        "max_rel_grad_norm_vs_solve": against["max_rel_gn"],
        "max_rel_x_vs_solve": against["max_rel_x"],
        "final_grad_norms": [r.grad_norms[-1] for r in rep.reports],
        "one_round_without_host_sync": True,
        "topk_slots_bitwise_equal": True,
        "trace": group_trace,
        "ls_group": {
            "specs": 2, "rounds": LS_GROUP_ROUNDS, "log": rep_ls.log, "launches": ls_launches,
            "bitwise_vs_solve": ls_against["bitwise"],
            "max_rel_grad_norm_vs_solve": ls_against["max_rel_gn"],
            "ls_steps": [list(map(int, r.ls_steps)) for r in rep_ls.reports],
            "ls_steps_differ_in_band": ls_against["ls_steps_differ_in_band"],
            "slots_bitwise_equal": True,
            "grad_norms": [list(r.grad_norms) for r in rep_ls.reports],
            "group_ms_per_round": rep_ls.reports[0].extras["batch_wall_time_s"]
            / LS_GROUP_ROUNDS * 1e3,
            "sequential_ms_per_round_sum": sum(ls_against["seq_ms_per_round"]),
        },
    }
    emit(out)
    return launches, out


def session_phase() -> dict:
    """Phase 9: a w8a TopK session stepped 3 rounds, saved, run to 10, and
    restored from its FNLS1 file and run to 10: both equal solve(rounds=10)
    on the card bit for bit; the file round-trips byte for byte."""
    from repro_torch.api import (
        DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=SESSION_ROUNDS)
    z_np = spec.data.build()
    want = solve(spec, z=z_np)
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path, again = where / "w8a_topk.fnlsess", where / "w8a_topk_again.fnlsess"
    with open_session(spec, z=z_np) as s:
        s.step(SESSION_SAVE_AT)
        s.save(path)
        stepped = s.run()
    with open_session(spec, z=z_np, restore=path) as s:
        check(s.round == SESSION_SAVE_AT, f"restored at round {s.round}")
        resumed = s.run()
    check(_reports_bitwise(stepped, want), "session step(3) + run != solve(rounds=10)")
    check(_reports_bitwise(resumed, want), "restored session != solve(rounds=10)")
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "FNLS1 load -> save changed the bytes")
    out = {
        "phase": "session", "spec": "w8a topk rounds=10", "saved_at": SESSION_SAVE_AT,
        "stepped_bitwise_vs_solve": True, "restored_bitwise_vs_solve": True,
        "fnls1_bytes": path.stat().st_size, "fnls1_round_trip_byte_identical": True,
        "grad_norms": list(want.grad_norms), "device": want.extras["device"],
    }
    path.unlink()
    again.unlink()
    emit(out)
    return out


def count_syncs(step) -> int:
    """Host syncs that ``step()`` makes, as torch.cuda.set_sync_debug_mode
    ("warn") reports them (one warning a synchronizing call)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _rel(got, want, floor: float) -> np.ndarray:
    got, want = np.asarray(got), np.asarray(want)
    keep = want >= floor
    return np.abs(got[keep] - want[keep]) / want[keep]


def _norms_close(got, want) -> bool:
    """Grad norms within TRAJECTORY_RTOL * norm + STAR_GN_ATOL where the
    reference norm is at least STAR_GN_FLOOR."""
    got, want = np.asarray(got), np.asarray(want)
    keep = want >= STAR_GN_FLOOR
    return bool(np.all(np.abs(got[keep] - want[keep])
                       <= TRAJECTORY_RTOL * want[keep] + STAR_GN_ATOL))


def star_phase(ops, dev) -> dict:
    """Phase 10: the wire stack on the card.  (a) star-loopback at w8a's
    whole shape, TopK (10 rounds) and TopLEK (3), against the card's local
    solve; launches, syncs and ms per round; (b) each codec's one-row encode
    on the card against the CPU's bytes; (c) FedNL-PP with RandK over
    loopback, tau 71, 20% dropout resampled, against the same run on the
    CPU; (d) star-tcp with 8 client processes at w8a's per-client width
    against loopback at that shape; (e) a star session saved at round 3 and
    restored.  Returns what the kernels line needs."""
    import torch

    from repro_torch import prng
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, FaultSpec, open_session, solve)
    from repro_torch.comm import wire
    from repro_torch.comm.star import run_star_master
    from repro_torch.compressors import get_compressor
    from repro_torch.kernels import compressor_select as tcs
    from repro_torch.launch.multiproc import ClientCluster
    from repro_torch.linalg import triu_size

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=STAR_ROUNDS)
    star_spec = spec.replace(backend="star-loopback")
    z_np = spec.data.build()
    n_clients, n_i, d = z_np.shape
    t_len, k = triu_size(d), spec.fednl_config().k_for(d)
    out: dict = {}

    # (a) star-loopback, TopK and TopLEK, each with the counts set to 0 before it
    def star_path(label, path_spec, per_client_round):
        local = solve(path_spec, z=z_np, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rep = solve(path_spec.replace(backend="star-loopback"), z=z_np, device=dev)
        launches = launch_counts(ops)
        rounds = path_spec.rounds
        want = {name: 0 for name in launches}
        want["hessian_syrk_packed"] = n_clients * (rounds + 1)
        want[per_client_round] = n_clients * rounds
        check(launches == want, f"{label}: launches {launches}, want {want}")
        check(rep.rounds == rounds and bool(np.all(np.isfinite(rep.grad_norms))),
              f"{label}: grad norms {rep.grad_norms}")
        rel = _rel(rep.grad_norms, local.grad_norms, STAR_GN_FLOOR)
        check(_norms_close(rep.grad_norms, local.grad_norms),
              f"{label}: star vs local grad norms differ: {rel}")
        check(list(rep.sent_bits) == list(local.sent_bits),
              f"{label}: sent_bits {rep.sent_bits} vs local {local.sent_bits}")
        check(list(rep.extras["measured_payload_bits"]) == list(rep.sent_bits_payload),
              f"{label}: measured payload bits differ from the analytic bits")
        check(list(8 * rep.extras["measured_frame_bytes"]) == list(local.sent_bits_wire),
              f"{label}: measured frames differ from the wire model")
        emit({
            "phase": "star", "part": "a", "path": label, "device": rep.extras["device"],
            "rounds": rounds, "clients": n_clients, "launches": launches,
            "grad_norms": rep.grad_norms.tolist(), "local_grad_norms": local.grad_norms.tolist(),
            "rel_err_above_floor": rel.tolist(), "floor": STAR_GN_FLOOR,
            "abs_err": np.abs(rep.grad_norms - local.grad_norms).tolist(),
            "rtol": TRAJECTORY_RTOL, "atol": STAR_GN_ATOL,
            "bitwise_vs_local": bool(np.array_equal(rep.grad_norms, local.grad_norms)),
            "sent_bits": rep.sent_bits.tolist(),
            "measured_frame_bytes": rep.extras["measured_frame_bytes"].tolist(),
            "init_time_s": rep.init_time_s, "ms_per_round": rep.wall_time_s / rounds * 1e3,
            "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
        })
        return rep, launches

    topk_rep, out["topk_launches"] = star_path(
        f"w8a star-loopback topk rounds={STAR_ROUNDS}", spec, "select_topk_idx")
    _, out["toplek_launches"] = star_path(
        f"w8a star-loopback toplek rounds={STAR_LEK_ROUNDS}",
        spec.replace(compressor=CompressorSpec("toplek"), rounds=STAR_LEK_ROUNDS),
        "select_toplek_idx")

    # (e) a session: syncs counted in round 2, saved at round 3, restored
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path = where / "w8a_star.fnlsess"
    with open_session(star_spec, z=z_np, device=dev) as s:
        s.step(1)
        syncs = count_syncs(lambda: s.step(1))
        star_trace = trace(lambda: s.step(1), 1, "round")
        s.step(SESSION_SAVE_AT - s.round)
        s.save(path)
        stepped = s.run()
    with open_session(star_spec, z=z_np, restore=path, device=dev) as s:
        check(s.round == SESSION_SAVE_AT, f"star session restored at round {s.round}")
        resumed = s.run()
    for label, rep in (("stepped", stepped), ("restored", resumed)):
        check(_reports_bitwise(rep, topk_rep), f"star session {label} != the uninterrupted run")
        check(list(rep.extras["measured_frame_bytes"]) ==
              list(topk_rep.extras["measured_frame_bytes"]), f"star session {label}: frames")
    emit({"phase": "star", "part": "e", "spec": f"w8a star-loopback topk rounds={STAR_ROUNDS}",
          "saved_at": SESSION_SAVE_AT, "stepped_bitwise": True, "restored_bitwise": True,
          "fnls1_bytes": path.stat().st_size,
          "host_syncs_per_round": syncs, "host_syncs_per_client_round": syncs / n_clients,
          "trace_third_round": star_trace,
          "note": "syncs: set_sync_debug_mode('warn') warnings over round 2 of the "
                  "session; every uplink leaves the card as bytes; the third round under "
                  "torch.profiler"})
    path.unlink()
    out["syncs_per_round"] = syncs

    # (b) each codec's one-row encode on the card against the CPU's
    rng = np.random.default_rng(10)
    rows = {
        "heavy_tailed": rng.standard_normal(t_len) * np.exp(rng.uniform(-20, 0, t_len)),
        "kept_zeros": np.where(rng.uniform(size=t_len) < 0.97, 0.0, rng.standard_normal(t_len)),
        "near_ties": near_tie_rows(1, t_len, 11)[0],
    }
    key = prng.split_one(prng.split(prng.prng_key(0), 2)[1], n_clients, 0)
    unif = float(prng.uniform(key))
    codecs = {}
    for name in ("identity", "topk", "randk", "randseqk", "toplek", "natural"):
        comp = get_compressor(name, t_len, k)
        card, cpu = wire.make_codec(comp, t_len, dev), wire.make_codec(comp, t_len, "cpu")
        boundary = 0
        for row_name, u in rows.items():
            got = card.encode(key, torch.as_tensor(u, device=dev))
            want = cpu.encode(key, torch.as_tensor(u))
            if name == "toplek" and got.sent_elems != want.sent_elems:
                check(abs(got.sent_elems - want.sent_elems) == 1
                      and toplek_near_boundary(u, k, unif),
                      f"codec toplek {row_name}: kept {got.sent_elems} vs {want.sent_elems}")
                boundary += 1
                continue
            check(got.data == want.data and got.bits == want.bits,
                  f"codec {name} {row_name}: card bytes differ from the CPU's")
            dec = card.decode(got.data, got.sent_elems)
            check(bits_equal(dec.cpu(), cpu.decode(want.data, want.sent_elems)),
                  f"codec {name} {row_name}: decodes differ")
        codecs[name] = {"rows": sorted(rows), "bytes_equal": True, "boundary_rows": boundary,
                        "bits_heavy_tailed": cpu.encode(key, torch.as_tensor(rows["heavy_tailed"])).bits}
    emit({"phase": "star", "part": "b", "codecs": codecs, "T": t_len, "k": k,
          "boundary_tol": TOPLEK_BOUNDARY})

    # (c) FedNL-PP over loopback: RandK, tau 71, 20% dropout resampled
    pp_spec = ExperimentSpec(
        data=DataSpec(dataset="w8a"), algorithm="fednl-pp", tau=PP_TAU, rounds=STAR_ROUNDS,
        compressor=CompressorSpec("randk"), fault=FaultSpec(drop_prob=STAR_PP_DROP),
        on_dropout="resample", backend="star-loopback",
    )
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pp = solve(pp_spec, z=z_np, device=dev)
    pp_launches = launch_counts(ops)
    contributions = sum(len(p) for p in pp.participants)
    want = {name: 0 for name in pp_launches}
    # a participant: SYRK, and threefry + TopK by keys three times (its
    # encode, the decode of its own message, the master's decode)
    want.update(hessian_syrk_packed=n_clients + contributions,
                threefry_uniform=3 * contributions, threefry_uniform_float32=3 * contributions,
                select_topk_by_keys_idx=3 * contributions)
    check(pp_launches == want, f"PP star launches {pp_launches}, want {want}")
    pp_cpu = solve(pp_spec, z=z_np, device="cpu")
    check(pp.participants == pp_cpu.participants, "PP star: participants differ from the CPU's")
    check(pp.dropped == pp_cpu.dropped, "PP star: drops differ from the CPU's")
    check(sum(len(x) for x in pp.dropped) > 0, "PP star: no client dropped")
    check(list(pp.sent_bits) == list(pp_cpu.sent_bits), "PP star: sent_bits differ from the CPU's")
    xh, xh_cpu = np.asarray(pp.x_hist), np.asarray(pp_cpu.x_hist)
    pp_rel = np.linalg.norm(xh - xh_cpu, axis=1) / np.linalg.norm(xh_cpu, axis=1)
    check(bool(np.all(pp_rel <= TRAJECTORY_RTOL)), f"PP star: card vs CPU models differ {pp_rel}")
    emit({"phase": "star", "part": "c", "spec": f"w8a fednl-pp randk tau={PP_TAU} drop_prob="
          f"{STAR_PP_DROP} resample rounds={STAR_ROUNDS}", "launches": pp_launches,
          "contributions": contributions, "drops": sum(len(x) for x in pp.dropped),
          "participants_exact": True, "x_rel_err_vs_cpu": pp_rel.tolist(),
          "final_grad_norm": pp.final_grad_norm, "ms_per_round": pp.wall_time_s / pp.rounds * 1e3})
    out["by_keys_idx_launches"] = pp_launches
    del pp_cpu

    # (d) star-tcp: 8 client processes at w8a's per-client width
    tcp_spec = ExperimentSpec(data=DataSpec(dataset="w8a", shape=TCP_SHAPE), rounds=TCP_ROUNDS)
    cfg = tcp_spec.fednl_config()
    t0 = time.perf_counter()
    cluster = ClientCluster("w8a", TCP_SHAPE, tcp_spec.seed, cfg=cfg, device=str(dev),
                            data_seed=tcp_spec.data.seed)
    spawn_s = time.perf_counter() - t0
    try:
        tcp = run_star_master(cluster.conns, cluster.d, cfg, rounds=TCP_ROUNDS, device=dev)
    finally:
        cluster.close(join_timeout=120)
    check(cluster.exit_codes() == [0] * TCP_SHAPE[1], f"TCP clients' exit codes {cluster.exit_codes()}")
    loop = solve(tcp_spec.replace(backend="star-loopback"), device=dev)
    check(list(tcp.sent_bits) == list(loop.sent_bits), "TCP vs loopback: sent_bits")
    check(list(tcp.measured_payload_bits) == list(loop.extras["measured_payload_bits"]),
          "TCP vs loopback: measured payload bits")
    check(list(tcp.measured_frame_bytes) == list(loop.extras["measured_frame_bytes"]),
          "TCP vs loopback: frame bytes")
    tcp_rel = _rel(tcp.grad_norms, loop.grad_norms, STAR_GN_FLOOR)
    check(_norms_close(tcp.grad_norms, loop.grad_norms), f"TCP vs loopback grad norms {tcp_rel}")
    emit({"phase": "star", "part": "d", "spec": f"star-tcp w8a shape={TCP_SHAPE} topk "
          f"rounds={TCP_ROUNDS}", "client_processes": TCP_SHAPE[1], "exit_codes": cluster.exit_codes(),
          "spawn_and_accept_s": spawn_s, "ms_per_round": tcp.wall_time_s / TCP_ROUNDS * 1e3,
          "loopback_ms_per_round": loop.wall_time_s / loop.rounds * 1e3,
          "grad_norms": tcp.grad_norms.tolist(), "rel_err_vs_loopback": tcp_rel.tolist(),
          "bitwise_vs_loopback": bool(np.array_equal(tcp.grad_norms, loop.grad_norms)),
          "measured_frame_bytes": tcp.measured_frame_bytes.tolist()})

    # the index forms at the star path's shape, one client, against their plain versions
    u1 = torch.as_tensor(rows["heavy_tailed"][None], device=dev).contiguous()
    keys1 = torch.as_tensor(rng.uniform(size=(1, t_len)).astype(np.float32), device=dev)
    unif1 = torch.tensor([unif], dtype=torch.float64, device=dev)
    idx_err = {}
    for name, kern, plain in (
        ("select_topk_idx", lambda: tcs.select_topk_idx_cuda(u1, k),
         lambda: tcs.select_topk_idx_plain(u1, k)),
        ("select_topk_by_keys_idx", lambda: tcs.select_topk_by_keys_idx_cuda(u1, keys1, k),
         lambda: tcs.select_topk_by_keys_idx_plain(u1, keys1, k)),
        ("select_toplek_idx", lambda: tcs.select_toplek_idx_cuda(u1, k, unif1),
         lambda: tcs.select_toplek_idx_plain(u1, k, unif1)),
    ):
        got, want = kern(), plain()
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"{name}: sent or idx differ from the plain version at (1, {t_len})")
        check(bits_equal(got[0], want[0]), f"{name}: u_hat differs from the plain version")
        idx_err[name] = (got[0] - want[0]).abs().max().item()
    ukeys = u1.abs().float()
    idx_ms = {
        "select_topk_idx": median_ms({
            "kernel": lambda: tcs.select_topk_idx_cuda(u1, k),
            "plain": lambda: tcs.select_topk_idx_plain(u1, k),
            "dense_form": lambda: tcs.select_topk_cuda(u1, k),
            "library": lambda: torch.topk(ukeys, k, dim=-1)}),
        "select_topk_by_keys_idx": median_ms({
            "kernel": lambda: tcs.select_topk_by_keys_idx_cuda(u1, keys1, k),
            "plain": lambda: tcs.select_topk_by_keys_idx_plain(u1, keys1, k),
            "dense_form": lambda: tcs.select_topk_by_keys_cuda(u1, keys1, k),
            "library": lambda: torch.topk(keys1, k, dim=-1)}),
        "select_toplek_idx": median_ms({
            "kernel": lambda: tcs.select_toplek_idx_cuda(u1, k, unif1),
            "plain": lambda: tcs.select_toplek_idx_plain(u1, k, unif1),
            "dense_form": lambda: tcs.select_toplek_cuda(u1, k, unif1)}),
    }
    kept1 = int(tcs.select_toplek_idx_cuda(u1, k, unif1)[1])
    p2 = 1 << (k - 1).bit_length()
    sort_ops = p2.bit_length() * (p2.bit_length() - 1) // 2 * (p2 // 2) * 2
    idx_bound = {  # u read, u_hat written, idx written, sent (and keys / unif read)
        "select_topk_idx": bound(t_len * 16 + k * 4 + 4, SELECT_OPS_PER_KEY * t_len,
                                 CUDA_CORE_32BIT_OPS),
        "select_topk_by_keys_idx": bound(t_len * 4 + k * 8 + t_len * 8 + k * 4 + 4,
                                         SELECT_OPS_PER_KEY * t_len, CUDA_CORE_32BIT_OPS),
        "select_toplek_idx": bound(t_len * 16 + 8 + kept1 * 4 + 4,
                                   SELECT_OPS_PER_KEY * t_len + 2 * sort_ops, CUDA_CORE_32BIT_OPS),
    }
    emit({"phase": "star", "part": "index_forms", "shape": [1, t_len], "k": k,
          "times_ms": idx_ms, "bound_ms": idx_bound, "max_abs_err": idx_err,
          "note": f"ms per call at the star path's one-client shape: median over {TIMED_REPS} "
                  f"event pairs around {CALLS_PER_EVENT} calls; dense_form = the same kernel "
                  "without the index output; library = torch.topk on the same f32 keys "
                  "(TopLEK has none)"})
    out.update(idx_ms=idx_ms, idx_bound=idx_bound, idx_err=idx_err, topk_rep=topk_rep, z_np=z_np)
    return out


def _tree_levels(topo, n_clients: int) -> tuple[int, int]:
    """(root subtrees, aggregators in all) of a resolved tree."""
    shape = topo.resolve(n_clients)

    def count(sub) -> int:
        return 1 + sum(count(c) for c in sub if isinstance(c, tuple))

    return len(shape), sum(count(sub) for sub in shape)


def _agg_root_bytes(measured: int, n_leaves: int, n_root_aggs: int) -> int:
    """The bytes of the exact tree's AGG frames at the root in one round: a
    32-byte header and a 4-byte count per frame, and per leaf entry a
    24-byte head and the leaf's payload (its frame less the 32-byte header)."""
    return 36 * n_root_aggs + measured - 8 * n_leaves


def topology_phase(ops, dev, star: dict) -> dict:
    """Phase 11: the tree of stars, bounded-staleness async aggregation and
    elastic membership on the card at w8a, through solve and open_session on
    star-loopback and star-tcp.  (a) the exact tree (fanout 4, depth 3: 20
    aggregators), TopK 10 rounds, bit for bit the flat star of phase 10 with
    its launch counts; (a') the same tree with RandK, 3 rounds, against the
    flat star's RandK; (b) combine="sum" (fanout 12, depth 2) within 1e-12 of
    the flat star's x, bits exact; (c) async: staleness 0 bit for bit the
    flat star, then staleness 2 over 20 rounds twice on the card and once on
    the CPU; (d) elastic: 12 joins at round 2, 12 leaves at round 5, against
    the CPU; (e) a TCP process tree of 2 aggregators of 4 clients each against
    the loopback tree; (f) sessions restored by replay; (g) obs: hop spans,
    frame counters and a profiled tree round.  Returns the launch counts."""
    import torch

    from repro_torch import obs
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, MembershipEvent, MembershipSpec,
        TopologySpec, open_session, solve)
    from repro_torch.comm.topology import make_master
    from repro_torch.launch.multiproc import ClientCluster, TreeClientCluster

    t_phase = time.perf_counter()
    z_np = star["z_np"]
    n_clients, _, d = z_np.shape
    base = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=TREE_ROUNDS, backend="star-loopback")
    flat = star["topk_rep"]  # phase 10's flat star-loopback TopK run, 10 rounds
    exact = TopologySpec(kind="tree", fanout=4, depth=3, combine="exact")
    n_root, n_aggs = _tree_levels(exact, n_clients)
    out: dict = {}
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)

    def reset():
        torch.cuda.synchronize()
        ops.reset_launch_counts()

    def zero_but(**want) -> dict:
        got = launch_counts(ops)
        return {name: want.get(name, 0) for name in got}

    def frames_bitwise(got, want) -> bool:
        return (list(got.extras["measured_frame_bytes"]) == list(want.extras["measured_frame_bytes"])
                and list(got.extras["measured_payload_bits"])
                == list(want.extras["measured_payload_bits"]))

    # (a) the exact tree, TopK, as a session stepped 3, saved, run to 10
    tree_spec = base.replace(topology=exact)
    tree_path = where / "w8a_tree.fnlsess"
    reset()
    with open_session(tree_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(tree_path)
        tree = s.run()
    launches = launch_counts(ops)
    want = zero_but(hessian_syrk_packed=n_clients * (TREE_ROUNDS + 1),
                    select_topk_idx=n_clients * TREE_ROUNDS)
    check(launches == want, f"exact tree: launches {launches}, want {want}")
    check(_reports_bitwise(tree, flat) and frames_bitwise(tree, flat),
          "exact tree != the flat star bit for bit")
    measured = [int(b) for b in tree.extras["measured_frame_bytes"]]
    root_bytes = [_agg_root_bytes(b, n_clients, n_root) for b in measured]
    emit({"phase": "topology", "part": "a", "spec": f"w8a star-loopback topk tree fanout=4 "
          f"depth=3 exact rounds={TREE_ROUNDS}", "root_subtrees": n_root, "aggregators": n_aggs,
          "device": tree.extras["device"], "launches": launches, "bitwise_vs_flat_star": True,
          "grad_norms": tree.grad_norms.tolist(), "sent_bits": tree.sent_bits.tolist(),
          "measured_frame_bytes": measured, "root_agg_frame_bytes": root_bytes,
          "init_time_s": tree.init_time_s, "ms_per_round": tree.wall_time_s / tree.rounds * 1e3,
          "flat_star_ms_per_round": flat.wall_time_s / flat.rounds * 1e3})
    out["tree_topk"] = launches

    # (a') the same tree with RandK: every hop decodes each leaf's message
    rk_spec = base.replace(compressor=CompressorSpec("randk"), rounds=TREE_RANDK_ROUNDS)
    reset()
    rk_flat = solve(rk_spec, z=z_np, device=dev)
    flat_rk = launch_counts(ops)
    reset()
    rk_tree = solve(rk_spec.replace(topology=exact), z=z_np, device=dev)
    tree_rk = launch_counts(ops)
    hops = 3  # the aggregators above a leaf (depth - 1) and the root
    per_leaf = 2 + hops  # encode, the leaf's own decode, each hop's decode
    for label, got, times in (("flat", flat_rk, 3), ("tree", tree_rk, per_leaf)):
        uses = times * n_clients * TREE_RANDK_ROUNDS
        want = zero_but(hessian_syrk_packed=n_clients * (TREE_RANDK_ROUNDS + 1),
                        threefry_uniform=uses, threefry_uniform_float32=uses,
                        select_topk_by_keys_idx=uses)
        check(got == want, f"randk {label}: launches {got}, want {want}")
    check(_reports_bitwise(rk_tree, rk_flat) and frames_bitwise(rk_tree, rk_flat),
          "exact tree RandK != the flat star bit for bit")
    emit({"phase": "topology", "part": "a_randk", "spec": f"w8a star-loopback randk tree "
          f"fanout=4 depth=3 exact rounds={TREE_RANDK_ROUNDS}", "bitwise_vs_flat_star": True,
          "launches": tree_rk, "flat_star_launches": flat_rk,
          "decodes_per_leaf_round": {"tree": 1 + hops, "flat": 2},
          "ms_per_round": rk_tree.wall_time_s / rk_tree.rounds * 1e3,
          "flat_star_ms_per_round": rk_flat.wall_time_s / rk_flat.rounds * 1e3})
    out["tree_randk"] = tree_rk

    # (b) combine="sum": 12 subtrees, one dense sum each; root bytes counted
    sum_topo = TopologySpec(kind="tree", fanout=12, depth=2, combine="sum")
    reset()
    with open_session(base.replace(topology=sum_topo), z=z_np, device=dev) as s:
        rec = obs.enable()
        s.step(TREE_ROUNDS)
        obs.disable()
        summed = s.report()
    sum_launches = launch_counts(ops)
    check(sum_launches == zero_but(hessian_syrk_packed=n_clients * (TREE_ROUNDS + 1),
                                   select_topk_idx=n_clients * TREE_ROUNDS),
          f"sum tree launches {sum_launches}")
    x_err = np.abs(summed.x - flat.x)
    check(bool(np.all(x_err <= SUM_TREE_ATOL + SUM_TREE_RTOL * np.abs(flat.x))),
          f"sum tree x vs the flat star: {x_err.max()}")
    check(list(summed.sent_bits) == list(flat.sent_bits), "sum tree sent_bits")
    sum_root = rec.value("comm.bytes.recv", type="AGG")
    emit({"phase": "topology", "part": "b", "spec": f"w8a star-loopback topk tree fanout=12 "
          f"depth=2 sum rounds={TREE_ROUNDS}", "x_max_abs_err_vs_flat": float(x_err.max()),
          "rtol": SUM_TREE_RTOL, "atol": SUM_TREE_ATOL, "sent_bits_exact": True,
          "bitwise_vs_flat_star": bool(np.array_equal(summed.x, flat.x)),
          "root_agg_frame_bytes_per_round": sum_root / TREE_ROUNDS,
          "exact_tree_root_agg_frame_bytes_per_round": statistics.mean(root_bytes),
          "leaf_frame_bytes_per_round": statistics.mean(measured),
          "ms_per_round": summed.wall_time_s / summed.rounds * 1e3})

    # (c) async: staleness 0 is the flat star; staleness 2 twice on the card, once on the CPU
    reset()
    sync0 = solve(base.replace(topology=TopologySpec(mode="async"), rounds=ASYNC_SYNC_ROUNDS),
                  z=z_np, device=dev)
    check([g.hex() for g in sync0.grad_norms] == [g.hex() for g in flat.grad_norms[:ASYNC_SYNC_ROUNDS]]
          and [r.f for r in sync0.records] == [r.f for r in flat.records[:ASYNC_SYNC_ROUNDS]]
          and list(sync0.sent_bits) == list(flat.sent_bits[:ASYNC_SYNC_ROUNDS])
          and list(sync0.extras["measured_frame_bytes"])
          == list(flat.extras["measured_frame_bytes"][:ASYNC_SYNC_ROUNDS]),
          "async staleness 0 != the flat star")
    async_topo = TopologySpec(mode="async", staleness=2, max_delay=3, schedule_seed=0)
    async_spec = base.replace(topology=async_topo, rounds=ASYNC_ROUNDS)
    async_path = where / "w8a_async.fnlsess"
    reset()
    with open_session(async_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(async_path)
        async1 = s.run()
        in_flight = len(s._handle._master._inflight)
    async_launches = launch_counts(ops)
    async2 = solve(async_spec, z=z_np, device=dev)
    t0 = time.perf_counter()
    async_cpu = solve(async_spec, z=z_np, device="cpu")
    async_cpu_s = time.perf_counter() - t0
    parts = [r.participants for r in async1.records]
    assigned = sum(len(p) for p in parts)
    check(parts == [r.participants for r in async_cpu.records], "async participants != the CPU's")
    check(_reports_bitwise(async1, async2) and frames_bitwise(async1, async2),
          "two async runs on the card differ")
    check(list(async1.sent_bits) == list(async_cpu.sent_bits), "async sent_bits != the CPU's")
    check(_norms_close(async1.grad_norms, async_cpu.grad_norms),
          f"async grad norms vs the CPU: {_rel(async1.grad_norms, async_cpu.grad_norms, STAR_GN_FLOOR)}")
    # a client computes (SYRK, then its encode) once per ROUND assignment;
    # every assignment has arrived or is still in flight at the end
    assignments = assigned + in_flight
    want = zero_but(hessian_syrk_packed=n_clients + assignments, select_topk_idx=assignments)
    check(async_launches == want, f"async launches {async_launches}, want {want}")
    emit({"phase": "topology", "part": "c", "spec": f"w8a star-loopback topk async staleness=2 "
          f"max_delay=3 schedule_seed=0 rounds={ASYNC_ROUNDS}",
          "staleness0_bitwise_vs_flat_star": True, "two_card_runs_bitwise": True,
          "participants_exact_vs_cpu": True, "participants_per_round": [len(p) for p in parts],
          "arrivals": assigned, "in_flight_at_end": in_flight, "launches": async_launches,
          "grad_norms": async1.grad_norms.tolist(),
          "rel_err_vs_cpu": _rel(async1.grad_norms, async_cpu.grad_norms, STAR_GN_FLOOR).tolist(),
          "ms_per_round": async1.wall_time_s / async1.rounds * 1e3,
          "cpu_run_s": async_cpu_s})
    out["async"] = async_launches
    del async_cpu

    # (d) elastic: clients 130-141 join at round 2, 0-11 leave at round 5
    events = tuple([MembershipEvent(ELASTIC_JOIN_AT, "join", c) for c in ELASTIC_JOINERS]
                   + [MembershipEvent(ELASTIC_LEAVE_AT, "leave", c) for c in ELASTIC_LEAVERS])
    el_spec = base.replace(membership=MembershipSpec(events=events), rounds=ELASTIC_ROUNDS)
    el_path = where / "w8a_elastic.fnlsess"
    leave_checks = []
    reset()
    with open_session(el_spec, z=z_np, device=dev) as s:
        master = s._handle._master
        apply_events = master._apply_events

        def checked(r, x):
            ev = apply_events(r, x)
            if ev["left"]:
                fresh = torch.mean(torch.stack([master._mirrors[c].clone() for c in master.order]),
                                   dim=0)
                leave_checks.append((r, bits_equal(master.h_global, fresh)))
            return ev

        master._apply_events = checked
        s.step(SESSION_SAVE_AT)
        s.save(el_path)
        elastic = s.run()
    el_launches = launch_counts(ops)
    check(leave_checks == [(ELASTIC_LEAVE_AT, True)],
          f"H_global after the leaves != a fresh mean of the survivors' mirrors: {leave_checks}")
    t0 = time.perf_counter()
    el_cpu = solve(el_spec, z=z_np, device="cpu")
    el_cpu_s = time.perf_counter() - t0
    el_parts = [r.participants for r in elastic.records]
    check(el_parts == [r.participants for r in el_cpu.records], "elastic participants != the CPU's")
    check(list(elastic.sent_bits) == list(el_cpu.sent_bits), "elastic sent_bits != the CPU's")
    check(_norms_close(elastic.grad_norms, el_cpu.grad_norms),
          f"elastic grad norms vs the CPU: {_rel(elastic.grad_norms, el_cpu.grad_norms, STAR_GN_FLOOR)}")
    t_len = d * (d + 1) // 2
    active_before = n_clients - len(ELASTIC_JOINERS)
    per_up = elastic.records[1].sent_bits_payload // active_before
    delta = elastic.records[2].sent_bits_payload - elastic.records[1].sent_bits_payload
    want_delta = len(ELASTIC_JOINERS) * (per_up + t_len * 64)
    check(delta == want_delta, f"elastic round-2 delta {delta}, want {want_delta}")
    rounds_active = sum(len(p) for p in el_parts)
    want = zero_but(hessian_syrk_packed=active_before + len(ELASTIC_JOINERS) + rounds_active,
                    select_topk_idx=rounds_active)
    check(el_launches == want, f"elastic launches {el_launches}, want {want}")
    emit({"phase": "topology", "part": "d", "spec": f"w8a star-loopback topk membership: "
          f"{len(ELASTIC_JOINERS)} join at round {ELASTIC_JOIN_AT}, {len(ELASTIC_LEAVERS)} leave "
          f"at round {ELASTIC_LEAVE_AT}, rounds={ELASTIC_ROUNDS}",
          "participants_per_round": [len(p) for p in el_parts], "participants_exact_vs_cpu": True,
          "sent_bits_exact_vs_cpu": True, "round2_delta_bits": delta,
          "round2_delta_want": want_delta, "leave_h_global_bitwise_fresh_mean": True,
          "launches": el_launches, "grad_norms": elastic.grad_norms.tolist(),
          "rel_err_vs_cpu": _rel(elastic.grad_norms, el_cpu.grad_norms, STAR_GN_FLOOR).tolist(),
          "ms_per_round": elastic.wall_time_s / elastic.rounds * 1e3, "cpu_run_s": el_cpu_s})
    out["elastic"] = el_launches
    del el_cpu

    # (f) the three sessions restored from their FNLS1 files by replay
    restored = {}
    for label, spec, path, want_rep in (("tree", tree_spec, tree_path, tree),
                                        ("async", async_spec, async_path, async1),
                                        ("elastic", el_spec, el_path, elastic)):
        with open_session(spec, z=z_np, restore=path, device=dev) as s:
            check(s.round == SESSION_SAVE_AT, f"{label} session restored at round {s.round}")
            rep = s.run()
        check(_reports_bitwise(rep, want_rep) and frames_bitwise(rep, want_rep)
              and [r.participants for r in rep.records] == [r.participants for r in want_rep.records],
              f"{label} session restored != the uninterrupted run")
        restored[label] = {"fnls1_bytes": path.stat().st_size, "restored_bitwise": True,
                           "init_and_replay_s": rep.init_time_s}
        path.unlink()
    emit({"phase": "topology", "part": "f", "saved_at": SESSION_SAVE_AT, "sessions": restored})

    # (e) a TCP process tree: 2 aggregator processes of 4 client processes each
    tcp_topo = TopologySpec(kind="tree", fanout=2, depth=2)
    tcp_spec = ExperimentSpec(data=DataSpec(dataset="w8a", shape=TCP_SHAPE), rounds=TCP_ROUNDS,
                              topology=tcp_topo)
    cfg = tcp_spec.fednl_config()
    live_before = ClientCluster.live_count()
    t0 = time.perf_counter()
    cluster = TreeClientCluster("w8a", TCP_SHAPE, tcp_spec.seed, tcp_topo, cfg=cfg,
                                device=str(dev), data_seed=tcp_spec.data.seed)
    spawn_s = time.perf_counter() - t0
    try:
        master = make_master(cluster.conns, cluster.d, cfg, topology=tcp_topo,
                             n_clients=cluster.n_clients, device=dev)
        master.init_handshake()
        t1 = time.perf_counter()
        tcp_m = [master.step_round(r) for r in range(TCP_ROUNDS)]
        tcp_s = time.perf_counter() - t1
        master.stop()
        tcp_x = master.x.cpu().numpy()
    finally:
        cluster.close(join_timeout=120)
    codes = cluster.exit_codes()
    check(codes == [0, 0], f"TCP tree aggregators' exit codes {codes}")
    check(ClientCluster.live_count() == live_before == 0, "a cluster is still live")
    loop = solve(tcp_spec.replace(backend="star-loopback"), device=dev)
    check([float(m["grad_norm"]).hex() for m in tcp_m] == [g.hex() for g in loop.grad_norms]
          and [m["sent_bits"] for m in tcp_m] == list(loop.sent_bits)
          and [m["measured_frame_bytes"] for m in tcp_m] == list(loop.extras["measured_frame_bytes"])
          and bool(np.array_equal(tcp_x, loop.x)), "TCP tree != the loopback tree bit for bit")
    emit({"phase": "topology", "part": "e", "spec": f"star-tcp w8a shape={TCP_SHAPE} topk tree "
          f"fanout=2 depth=2 rounds={TCP_ROUNDS}", "aggregator_processes": 2,
          "client_processes": TCP_SHAPE[1], "aggregator_exit_codes": codes,
          "live_clusters_after": ClientCluster.live_count(), "bitwise_vs_loopback_tree": True,
          "spawn_and_connect_s": spawn_s, "ms_per_round": tcp_s / TCP_ROUNDS * 1e3,
          "loopback_ms_per_round": loop.wall_time_s / loop.rounds * 1e3,
          "grad_norms": loop.grad_norms.tolist()})

    # (g) obs: a tree round and a flat-star round under a live recorder
    def obs_round(spec, want_rep):
        with open_session(spec, z=z_np, device=dev) as s:
            s.step(1)
            rec = obs.enable()
            s.step(1)
            obs.disable()
            third = trace(lambda: s.step(1), 1, "round")
            rep = s.report()
        check([g.hex() for g in rep.grad_norms] == [g.hex() for g in want_rep.grad_norms[:3]]
              and list(rep.extras["measured_frame_bytes"])
              == list(want_rep.extras["measured_frame_bytes"][:3]),
              "a round under the recorder differs from the run without it")
        return rec, rep, third

    rec_t, rep_t, tree_trace = obs_round(tree_spec, tree)
    hops = rec_t.spans("comm.hop")
    check(len(hops) == n_aggs and sorted(h.labels["node"] for h in hops if h.depth == 1)
          == list(range(n_root)), f"comm.hop spans: {len(hops)}, want {n_aggs}")
    measured1 = int(rep_t.extras["measured_frame_bytes"][1])
    check(rec_t.value("comm.bytes.recv", type="UPLINK") == measured1,
          "UPLINK bytes received != the measured frame bytes")
    # each leaf's entry crosses depth - 1 = 2 AGG hops (sub-aggregator -> root
    # subtree aggregator -> root)
    want_agg = 36 * n_aggs + 2 * (measured1 - 8 * n_clients)
    check(rec_t.value("comm.bytes.recv", type="AGG") == want_agg,
          f"AGG bytes {rec_t.value('comm.bytes.recv', type='AGG')}, want {want_agg}")
    round_span = rec_t.spans("comm.round")
    check(len(round_span) == 1, "one comm.round span")
    by_level = {}
    for h in hops:
        by_level.setdefault(h.depth, []).append(h.dur_s * 1e3)
    rec_s, _, _ = obs_round(base, flat)
    check(rec_s.value("comm.bytes.recv", type="UPLINK")
          == int(flat.extras["measured_frame_bytes"][1]), "flat star UPLINK bytes")
    emit({"phase": "topology", "part": "g", "obs_on_bitwise_vs_off": True,
          "tree": {"hop_spans": len(hops), "round_ms": round_span[0].dur_s * 1e3,
                   "hop_ms_by_level": {f"level_{lvl}": {"count": len(v), "mean": statistics.mean(v),
                                                       "max": max(v), "sum": sum(v)}
                                       for lvl, v in sorted(by_level.items())},
                   "uplink_bytes_recv": measured1,
                   "agg_bytes_recv": rec_t.value("comm.bytes.recv", type="AGG"),
                   "agg_bytes_recv_want": want_agg,
                   "root_agg_frame_bytes": _agg_root_bytes(measured1, n_clients, n_root),
                   "frames_recv": {k: v for k, v in rec_t.snapshot()["counters"].items()
                                   if k.startswith("comm.frames.recv")},
                   "trace_third_round": tree_trace},
          "flat_star": {"round_ms": rec_s.spans("comm.round")[0].dur_s * 1e3,
                        "uplink_bytes_recv": rec_s.value("comm.bytes.recv", type="UPLINK")},
          "note": "hop spans: fan-down, the children's collection and the reply of each "
                  "aggregator, nested (level 2 inside level 1 inside the root's comm.round); "
                  "the tree session's third round under torch.profiler"})
    emit({"phase": "topology", "seconds": time.perf_counter() - t_phase})
    return out


def _records_bitwise(got, want) -> bool:
    """Two RunReports agree record for record bit for bit (floats by their
    hex, PP models and participants too) and in their final x."""
    def key(r):
        return ([None if v is None else float(v).hex() for v in (r.grad_norm, r.f, r.l)],
                r.sent_elems, r.sent_bits, r.sent_bits_payload, r.sent_bits_wire, r.ls_steps,
                r.participants, None if r.x is None else np.asarray(r.x).tobytes())
    return (got.rounds == want.rounds and [key(r) for r in got.records] == [key(r) for r in want.records]
            and bool(np.array_equal(got.x, want.x)))


def _tenant_against_solve(name: str, got, want, n_clients: int) -> dict:
    """A served tenant against its own solve() on the card: the same rounds,
    sent_bits exact every round (TopLEK: phase 3's boundary allowance, a
    round's kept count may differ by one a client), grad norms within
    TRAJECTORY_RTOL where the solve's is >= SWEEP_GN_FLOOR."""
    check(got.rounds == want.rounds, f"{name}: {got.rounds} rounds, its solve {want.rounds}")
    check(bool(np.all(np.isfinite(got.x))) and got.x.shape == want.x.shape, f"{name}: x")
    differ = [r for r in range(want.rounds) if got.sent_bits[r] != want.sent_bits[r]]
    if name.endswith("toplek"):
        for r in differ:
            d_elems = abs(got.records[r].sent_elems - want.records[r].sent_elems)
            check(0 < d_elems <= n_clients, f"{name}: round {r} sent_elems differ by {d_elems}")
    else:
        check(not differ, f"{name}: sent_bits differ at rounds {differ}")
    rel = _rel(got.grad_norms, want.grad_norms, SWEEP_GN_FLOOR)
    check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{name}: grad norms differ: {rel.max()}")
    return {"bitwise": _records_bitwise(got, want),
            "max_rel_grad_norm": float(rel.max()) if rel.size else 0.0,
            "boundary_rounds": differ}


def serve_phase(ops, dev, sweep: dict) -> dict:
    """Phase 12: the FedNL serving engine and its gateway at w8a's whole
    shape, on the card: (a) the README grid and a TopLEK tenant through one
    engine under memory pressure, exact launch counts, each tenant against
    its solve(); (b) one TopK spec in groups of 1, 2, 4 and 8; (c) evict at
    round 3 and resume in a fresh engine; (d) a star-loopback and a FedNL-PP
    tenant beside a batch group, each its own session bit for bit; (e) the
    gateway over TCP on 127.0.0.1; (f) where an 8-slot tick's time goes."""
    import threading

    import torch

    from repro_torch import obs
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)
    from repro_torch.comm.protocol import Frame, MsgType
    from repro_torch.core.fednl_batch import BatchRoundTable
    from repro_torch.gateway import GatewayClient, GatewayConfig, GatewayError, GatewayServer
    from repro_torch.gateway import protocol as gwp
    from repro_torch.serve_fednl import FedNLServer, ServeConfig
    from repro_torch.serve_fednl.scheduler import stack_states, unstack_state

    base = ExperimentSpec(data=DataSpec(dataset="w8a", seed=0), rounds=SERVE_ROUNDS)
    specs = list(base.grid(seed=range(4), compressor=["topk", "randseqk", "natural"]).specs())
    specs.append(base.replace(compressor=CompressorSpec("toplek"), tol=1e-12))
    z_np = base.data.build()
    n_clients = z_np.shape[0]
    solves: dict = {}

    def solve_of(spec):
        if spec not in solves:
            solves[spec] = solve(spec, z=z_np)
        return solves[spec]

    def label(spec) -> str:
        return f"seed={spec.seed} {spec.compressor.name}"

    out: dict = {"phase": "serve"}

    # (a) the batched lane under memory pressure; each batched round's chunk
    # recorded (its branches, its padded slots) to reckon the launches
    chunks: list[tuple[set, int]] = []
    table_tick = BatchRoundTable.tick

    def recording_tick(self, comp_idx, state_b):
        chunks.append(({self.branch_keys[i][0] for i in comp_idx}, len(comp_idx)))
        return table_tick(self, comp_idx, state_b)

    BatchRoundTable.tick = recording_tick
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with FedNLServer(ServeConfig(**SERVE_CONFIG)) as srv:
            handles = [srv.submit(spec) for spec in specs[:SERVE_EARLY]]
            for _ in range(SERVE_EARLY_TICKS):
                srv.tick()
            handles += [srv.submit(spec) for spec in specs[SERVE_EARLY:]]
            srv.serve_until_idle(max_ticks=2000)
            stats = srv.stats()
            reports = [h.result() for h in handles]
    finally:
        BatchRoundTable.tick = table_tick
    serve_s = time.perf_counter() - t0
    launches = launch_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    check(len(chunks) == stats["batch_launches"], f"chunks {len(chunks)} vs {stats}")
    admissions = sum(stats["admissions_by_class"].values())
    want = {name: 0 for name in launches}
    want["hessian_syrk_packed"] = admissions + stats["batch_launches"]
    for comp, kernel in (("topk", "select_topk"), ("randseqk", "select_randseqk"),
                         ("toplek", "select_toplek"), ("natural", "threefry_uniform_float64")):
        want[kernel] = sum(comp in branches for branches, _ in chunks)
    want["threefry_uniform"] = want["threefry_uniform_float64"]
    check(launches == want, f"serve launches {launches}, want {want}")
    check(stats["spills"] > 0 and stats["resumes"] == stats["spills"]
          and stats["finished"] == len(specs), f"serve stats {stats}")
    against = {label(spec): _tenant_against_solve(f"serve {label(spec)}", got, solve_of(spec),
                                                  n_clients)
               for spec, got in zip(specs, reports)}
    live = sum(r.rounds for r in reports)
    padded = sum(n for _, n in chunks)
    check(abs(stats["batch_occupancy"] - live / padded) < 1e-12, "occupancy")
    emit({"phase": "serve", "part": "stats", "stats": stats})
    out["batched"] = {
        "tenants": [label(spec) for spec in specs], "config": SERVE_CONFIG,
        "submitted_first": SERVE_EARLY, "ticks_before_the_rest": SERVE_EARLY_TICKS,
        "launches": launches, "admissions": admissions, "slot_rounds_live": live,
        "slot_rounds_padded": padded, "serve_s": serve_s, "peak_memory_bytes": peak,
        "bitwise_vs_solve": {k: v["bitwise"] for k, v in against.items()},
        "max_rel_grad_norm_vs_solve": max(v["max_rel_grad_norm"] for v in against.values()),
        "toplek_boundary_rounds": against[label(specs[-1])]["boundary_rounds"],
        "rounds": [r.rounds for r in reports],
        "final_grad_norms": [r.grad_norms[-1] for r in reports],
    }
    emit({"phase": "serve", "part": "a_batched", **out["batched"]})
    del reports, handles

    # (b) one TopK spec served alone (bucket 1) and in groups of 2, 4 and 8
    target = base.replace(rounds=GROUP_ROUNDS)
    partners = [base.replace(rounds=GROUP_ROUNDS, seed=s, compressor=CompressorSpec(c))
                for s, c in ((1, "randseqk"), (2, "natural"), (3, "topk"), (4, "randseqk"),
                             (5, "natural"), (6, "topk"), (7, "randseqk"))]
    by_size = {}
    for size in GROUP_SIZES:
        with FedNLServer(ServeConfig(max_resident=8, admit_per_tick=8, max_group=8)) as srv:
            hs = [srv.submit(spec) for spec in [target] + partners[:size - 1]]
            srv.serve_until_idle()
            check(srv.stats()["batch_occupancy"] == 1.0, f"group of {size}: padded")
            by_size[size] = hs[0].result()
    want_b = solve_of(target)
    sizes = {}
    for size, got in by_size.items():
        row = _tenant_against_solve(f"group of {size} topk", got, want_b, n_clients)
        row["bitwise_vs_alone"] = _records_bitwise(got, by_size[1])
        row["bitwise_vs_group_of_2"] = _records_bitwise(got, by_size[2])
        rel_alone = _rel(got.grad_norms, by_size[1].grad_norms, 0.0)
        row["max_rel_grad_norm_vs_alone"] = float(rel_alone.max())
        sizes[size] = row
    out["group_size"] = {"spec": "w8a topk seed=0 rounds=10", "by_slots": sizes}
    emit({"phase": "serve", "part": "b_group_size", **out["group_size"]})

    # (c) evicted at round 3 to FNLS1, resumed alone in a fresh engine
    spec_c = base.replace(rounds=EVICT_ROUNDS, seed=5, compressor=CompressorSpec("randseqk"))
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    with FedNLServer() as srv:
        h = srv.submit(spec_c)
        srv.serve_until_idle()
        alone = h.result()
    with FedNLServer(ServeConfig(spill_dir=where / "serve_spills")) as srv:
        h = srv.submit(spec_c)
        for _ in range(EVICT_AT):
            srv.tick()
        path = srv.evict(h.id)
    again = where / "serve_evicted_again.fnlsess"
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "serve: FNLS1 load -> save changed the bytes")
    with FedNLServer() as srv:
        h = srv.resume(path)
        check(h.round == EVICT_AT, f"resumed at round {h.round}")
        srv.serve_until_idle()
        resumed = h.result()
    check(_records_bitwise(resumed, alone), "serve: evicted and resumed != served alone")
    out["spill_resume"] = {"spec": label(spec_c), "evicted_at": EVICT_AT,
                           "fnls1_bytes": path.stat().st_size, "round_trip_byte_identical": True,
                           "resumed_bitwise_vs_alone": True}
    for f in (path, again):
        f.unlink()
    (where / "serve_spills").rmdir()
    emit({"phase": "serve", "part": "c_spill_resume", **out["spill_resume"]})

    # (d) the solo lane beside a batch group, launch counts set to 0 before
    star = base.replace(rounds=SOLO_STAR_ROUNDS, backend="star-loopback")
    pp = base.replace(algorithm="fednl-pp", tau=PP_TAU, rounds=SOLO_PP_ROUNDS)
    pair = [base.replace(rounds=SOLO_STAR_ROUNDS, seed=s) for s in (0, 1)]
    ops.reset_launch_counts()
    with FedNLServer() as srv:
        hs = [srv.submit(spec) for spec in [star, pp] + pair]
        check([h._tenant.lane for h in hs] == ["solo", "solo", "batch", "batch"], "lanes")
        srv.serve_until_idle()
        st_d = srv.stats()
        served = [h.result() for h in hs]
    solo_launches = launch_counts(ops)
    want = {name: 0 for name in solo_launches}
    want["hessian_syrk_packed"] = (n_clients * (SOLO_STAR_ROUNDS + 1)  # star: init + a round
                                   + SOLO_PP_ROUNDS + 2  # PP: init, warm-up, rounds
                                   + len(pair) + st_d["batch_launches"])
    want["select_topk_idx"] = n_clients * SOLO_STAR_ROUNDS
    want["select_topk"] = SOLO_PP_ROUNDS + 1 + st_d["batch_launches"]
    check(solo_launches == want, f"solo lane launches {solo_launches}, want {want}")
    for spec, got in zip((star, pp), served[:2]):
        with open_session(spec, z=z_np) as sess:
            mine = sess.run()
        check(_records_bitwise(got, mine), f"serve solo {spec.backend} {spec.algorithm}: "
                                           "not its session bit for bit")
    for spec, got in zip(pair, served[2:]):
        _tenant_against_solve(f"solo-lane neighbour {label(spec)}", got, solve_of(spec), n_clients)
    out["solo_lane"] = {"tenants": ["star-loopback topk 3 rounds",
                                    f"fednl-pp topk tau={PP_TAU} 5 rounds",
                                    "2 batched topk 3 rounds"],
                        "launches": solo_launches, "bitwise_vs_session": True}
    emit({"phase": "serve", "part": "d_solo_lane", **out["solo_lane"]})

    # (e) the gateway: a port server on 127.0.0.1 with the engine on the card
    gw_specs = [base.replace(rounds=GATEWAY_ROUNDS, seed=s, compressor=CompressorSpec(c))
                for s, c in ((0, "topk"), (1, "randseqk"), (2, "natural"), (3, "topk"))]
    rec = obs.enable(span_capacity=4096)
    server = GatewayServer(GatewayConfig(port=0, serve=ServeConfig(**SERVE_CONFIG)))
    ready, addr = threading.Event(), {}

    def announce(host, port):
        addr.update(host=host, port=port)
        ready.set()

    thread = threading.Thread(target=server.run, kwargs={"ready": announce}, daemon=True)
    thread.start()
    try:
        check(ready.wait(60), "gateway did not bind")
        with GatewayClient(addr["host"], addr["port"]) as gwc:
            hs = [gwc.submit(spec) for spec in gw_specs]
            streamed, drops = {}, 0
            for h in hs:
                with GatewayClient(addr["host"], addr["port"]) as observer:
                    streamed[h.id] = list(observer.stream(h.id))
                    drops += observer.stream_drops
            results = [gwc.result(h.id) for h in hs]
            refused = {}
            try:
                gwc.submit(gw_specs[0], priority="platinum")
            except GatewayError as exc:
                refused["priority"] = exc.field
            raw = json.loads(gwp.pack_submit(gw_specs[0])[4:].decode())
            raw["spec"]["data"]["warp"] = 1
            try:
                gwc._rpc(Frame(type=MsgType.SUBMIT, payload=gwp._pack(
                    {k: raw[k] for k in ("spec_wire_version", "spec", "until", "tenant_id",
                                         "options")})))
            except GatewayError as exc:
                refused["unknown_field"] = exc.field
            metrics = gwc.metrics()
        latencies = server.tick_latencies()
    finally:
        server.request_stop()
        thread.join(60)
        obs.disable()
    check(not thread.is_alive(), "the gateway's thread did not stop")
    check(refused == {"priority": "options.priority", "unknown_field": "data.warp"},
          f"bad submissions refused as {refused}")
    check(drops == 0, f"{drops} records dropped")
    for spec, h, got in zip(gw_specs, hs, results):
        check(_records_bitwise(dataclasses.replace(got, records=streamed[h.id]), got),
              f"gateway {label(spec)}: streamed records != the report's")
        _tenant_against_solve(f"gateway {label(spec)}", got, solve_of(spec), n_clients)
    series = sorted({k.split("{")[0] for kind in ("counters", "histograms", "gauges")
                     for k in metrics["metrics"].get(kind, {}) if k.startswith("engine.")})
    check(metrics["enabled"] and "engine.rounds" in series and "engine.tick" in series,
          f"METRICS series {series}")
    lat_ms = np.asarray(latencies) * 1e3
    out["gateway"] = {
        "tenants": [label(spec) for spec in gw_specs], "rounds": GATEWAY_ROUNDS,
        "streamed_equal_reports": True, "refused_fields": refused, "engine_series": series,
        "ticks": len(latencies), "tick_ms_p50": float(np.percentile(lat_ms, 50)),
        "tick_ms_p99": float(np.percentile(lat_ms, 99)), "spans_recorded": len(rec.spans()),
    }
    emit({"phase": "serve", "part": "e_gateway", **out["gateway"]})

    # (f) where an 8-slot tick's time goes: the first 8 tenants of (a), no
    # pressure, host clock around synchronised ticks, then one profiled tick
    with FedNLServer(ServeConfig(max_resident=8, admit_per_tick=8, max_group=8)) as srv:
        for spec in specs[:8]:
            srv.submit(spec)
        srv.tick()  # admission and the first round
        srv.tick()
        tick_s = []
        for _ in range(TICK_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            srv.tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t1)
        prof = trace(srv.tick, 1, "tick")
        states = [t.state for t in srv._tenants.values() if t.status == "running"]
        check(len(states) == 8, f"{len(states)} resident")
        stack_ms = median_ms({"stack": lambda: stack_states(states)}, reps=5, calls=1)["stack"]
        stacked = stack_states(states)
        t1 = time.perf_counter()
        for _ in range(TICK_REPS):
            [unstack_state(stacked, i) for i in range(8)]
        unstack_ms = (time.perf_counter() - t1) / TICK_REPS * 1e3
        del stacked, states
    ms_tick = statistics.median(tick_s) * 1e3
    per_slot_ms = prof.get("device_ms_per_tick", float("nan")) / 8
    out["tick"] = {
        "slots": 8, "ms_per_tick_median": ms_tick, "ms_per_tick": [t * 1e3 for t in tick_s],
        "tenant_rounds_per_s": 8 / (ms_tick / 1e3),
        "sweep_group_ms_per_round_12_specs": sweep["group_ms_per_round"],
        "sweep_spec_rounds_per_s": 12 / (sweep["group_ms_per_round"] / 1e3),
        "sum_of_12_solves_ms_per_round": sweep["sequential_ms_per_round_sum"],
        "stack_8_states_device_ms": stack_ms, "unstack_8_states_host_ms": unstack_ms,
        "stack_bytes": 2 * 8 * n_clients * z_np.shape[-1] * (z_np.shape[-1] + 1) // 2 * 8,
        "occupancy_a": stats["batch_occupancy"], "pad_slot_rounds_a": padded - live,
        "pad_device_ms_a_reckoned": (padded - live) * per_slot_ms,
        "profiled_tick": prof,
    }
    emit({"phase": "serve", "part": "f_tick", **out["tick"]})
    out["launches"] = launches
    return out


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def sharded_phase(ops, dev, local_ms_per_round: float) -> dict:
    """Phase 13: the sharded backend at w8a's whole shape on a world of one
    (NCCL on the card, rank 0 in this process).  (a) dense_psum, TopK, 10
    rounds, against the card's local solve; (b) sparse_allgather through
    the index form against the CPU run of the port, and the support of
    H^2 - H^1 against the CPU's; each with exact launch counts and a round
    under set_sync_debug_mode("error"); (c) RandSeqK and RandK under
    sparse_allgather, 3 rounds, against the CPU run: every client's index
    set every round, bits, grad norms; (d) a sparse_allgather session
    stepped 3, saved, restored and run to 10, bit for bit (b)'s run, its
    FNLS1 file resumed on the CPU; then the index form timed at (142, T).
    Returns each part's launches and the batched index form's figures."""
    import torch
    import torch.distributed

    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)
    from repro_torch.api.accounting import sharded_uplink_bits
    from repro_torch.distributed import (
        make_sharded_fednl_round, shard_problem, sharded_fednl_init, world_of_one)
    from repro_torch.kernels import compressor_select as tcs
    from repro_torch.linalg import triu_size
    from repro_torch.objectives.logreg import logreg_oracles_packed

    t_phase = time.perf_counter()
    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=SHARDED_ROUNDS,
                          backend="sharded", devices=1)
    z_np = spec.data.build()
    n_clients, n_i, d = z_np.shape
    cfg = spec.fednl_config()
    t_len, k = triu_size(d), cfg.k_for(d)
    cpu = torch.device("cpu")
    out: dict = {"launches": {}}

    def counted(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, launch_counts(ops)

    def expected(launches, per_round: tuple, rounds: int, syrk: int) -> dict:
        want = {name: 0 for name in launches}
        want.update({name: rounds for name in per_round})
        want["hessian_syrk_packed"] = syrk
        return want

    def bits_of(rep) -> dict:
        return {col: [getattr(r, col) for r in rep.records]
                for col in ("sent_elems", "sent_bits", "sent_bits_payload", "sent_bits_wire")}

    # (a), (b): solve() on the card, the counts set to 0 before each
    local = solve(spec.replace(backend="local"), z=z_np, device=dev)
    reps = {}
    for agg, kernel in (("dense_psum", "select_topk"), ("sparse_allgather", "select_topk_idx")):
        path_spec = spec.replace(aggregate=agg)
        rep, launches = counted(lambda: solve(path_spec, z=z_np, device=dev))
        # every round and the warm-up round; SYRK also at init
        want = expected(launches, (kernel,), SHARDED_ROUNDS + 1, SHARDED_ROUNDS + 2)
        check(launches == want, f"sharded {agg}: launches {launches}, want {want}")
        check(rep.rounds == SHARDED_ROUNDS and bool(np.all(np.isfinite(rep.grad_norms))),
              f"sharded {agg}: grad norms {rep.grad_norms}")
        check(rep.extras == {"devices": 1, "aggregate": agg, "device": local.extras["device"]},
              f"sharded {agg}: extras {rep.extras}")
        against = {"local_card": local}
        if agg == "sparse_allgather":
            against["sharded_cpu"] = solve(path_spec, z=z_np, device="cpu")
        rel = {}
        for name, ref in against.items():
            rel[name] = _rel(rep.grad_norms, ref.grad_norms, STAR_GN_FLOOR).tolist()
            check(_norms_close(rep.grad_norms, ref.grad_norms),
                  f"sharded {agg} vs {name}: grad norms differ {rel[name]}")
            check(bits_of(rep) == bits_of(ref), f"sharded {agg} vs {name}: bits differ")
        reps[agg] = rep
        out["launches"][agg] = launches
        emit({"phase": "sharded", "part": "a" if agg == "dense_psum" else "b",
              "spec": f"w8a sharded {agg} topk rounds={SHARDED_ROUNDS} devices=1",
              "device": rep.extras["device"], "launches": launches,
              "grad_norms": rep.grad_norms.tolist(), "rel_err_above_floor": rel,
              "floor": STAR_GN_FLOOR, "rtol": TRAJECTORY_RTOL, "atol": STAR_GN_ATOL,
              "bits_exact_vs": sorted(against), "sent_bits": rep.sent_bits.tolist(),
              "bitwise_vs_local": bool(np.array_equal(rep.grad_norms, local.grad_norms)),
              "init_time_s": rep.init_time_s, "ms_per_round": rep.wall_time_s / rep.rounds * 1e3,
              "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
              "phase4_local_ms_per_round": local_ms_per_round})

    # function-level rounds on a device: the states (for the messages'
    # supports) and the metrics
    world_of_one(dev)

    def rounds_on(device, agg: str, comp_cfg, rounds: int):
        z = shard_problem(z_np, device=device)
        st = sharded_fednl_init(z, comp_cfg, seed=spec.seed)
        round_fn = make_sharded_fednl_round(z, comp_cfg, aggregate=agg)
        states, metrics = [st], []
        for _ in range(rounds):
            st, m = round_fn(st)
            states.append(st)
            metrics.append(m)
        return round_fn, states, metrics

    # round 1 (the second: round 0's corrections are 0 under hess0="exact")
    # under set_sync_debug_mode("error"); sparse_allgather's H^2 - H^1 support
    syncs = {}
    for agg in ("dense_psum", "sparse_allgather"):
        round_fn, states, _ = rounds_on(dev, agg, cfg, 1)  # round 0 also builds NCCL's communicator
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st2, _ = round_fn(states[-1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs[agg] = 0
        if agg == "sparse_allgather":
            card_support = (st2.h_global != states[1].h_global).cpu()
            x1, h1 = states[1].x, states[1].h_local
        emit({"phase": "trace", "path": f"sharded {agg} topk (world of one)",
              **trace_rounds(round_fn, st2, 3)})
        del round_fn, states, st2
    _, cpu_states, _ = rounds_on(cpu, "sparse_allgather", cfg, 2)
    cpu_support = cpu_states[2].h_global != cpu_states[1].h_global
    del cpu_states
    check(bool(card_support.any()) and torch.equal(card_support, cpu_support),
          "sparse_allgather: the support of H^2 - H^1 differs from the CPU's")
    emit({"phase": "sharded", "part": "syncs_and_support", "host_syncs_per_round": syncs,
          "sync_debug_mode": "error", "support_h2_minus_h1": int(card_support.sum()),
          "support_equal_to_cpu": True})

    # (c) RandSeqK and RandK under sparse_allgather, card against CPU
    for comp, per_round in (("randseqk", ("select_randseqk",)),
                            ("randk", ("threefry_uniform", "threefry_uniform_float32",
                                       "select_topk_by_keys_idx"))):
        comp_cfg = spec.replace(compressor=CompressorSpec(comp)).fednl_config()
        (_, card_st, card_m), launches = counted(
            lambda: rounds_on(dev, "sparse_allgather", comp_cfg, SHARDED_RANDOM_ROUNDS))
        want = expected(launches, per_round, SHARDED_RANDOM_ROUNDS, SHARDED_RANDOM_ROUNDS + 1)
        check(launches == want, f"sharded {comp}: launches {launches}, want {want}")
        _, cpu_st, cpu_m = rounds_on(cpu, "sparse_allgather", comp_cfg, SHARDED_RANDOM_ROUNDS)
        sets = 0
        for r in range(1, SHARDED_RANDOM_ROUNDS):  # round 0 sends zeros
            card_sets = (card_st[r + 1].h_local != card_st[r].h_local).cpu()
            check(torch.equal(card_sets, cpu_st[r + 1].h_local != cpu_st[r].h_local),
                  f"sharded {comp} round {r}: the clients' index sets differ from the CPU's")
            sets += int(card_sets.sum())
        for col in ("sent_elems", "sent_bits", "sent_bits_payload", "sent_bits_wire"):
            check([int(getattr(m, col)) for m in card_m] == [int(getattr(m, col)) for m in cpu_m],
                  f"sharded {comp}: {col} differ from the CPU's")
        gn = np.array([float(m.grad_norm) for m in card_m])
        gn_cpu = np.array([float(m.grad_norm) for m in cpu_m])
        check(_norms_close(gn, gn_cpu), f"sharded {comp}: grad norms {gn} vs CPU {gn_cpu}")
        out["launches"][f"sparse_allgather_{comp}"] = launches
        emit({"phase": "sharded", "part": "c", "compressor": comp, "rounds": SHARDED_RANDOM_ROUNDS,
              "launches": launches, "index_sets_exact": True, "entries_sent": sets,
              "grad_norms": gn.tolist(), "cpu_grad_norms": gn_cpu.tolist(),
              "sent_bits": [int(m.sent_bits) for m in card_m]})
        del card_st, cpu_st

    # (d) a session: step 3, save, restore, run to 10; the file on the CPU
    sparse_spec = spec.replace(aggregate="sparse_allgather")
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path, again = where / "w8a_sharded.fnlsess", where / "w8a_sharded_again.fnlsess"
    with open_session(sparse_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(path)
        stepped = s.run()
    with open_session(sparse_spec, z=z_np, restore=path, device=dev) as s:
        check(s.round == SESSION_SAVE_AT, f"sharded session restored at round {s.round}")
        resumed = s.run()
    for label, got in (("stepped", stepped), ("restored", resumed)):
        check(_records_bitwise(got, reps["sparse_allgather"]),
              f"sharded session {label} != the uninterrupted run")
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "sharded FNLS1 load -> save changed the bytes")
    with open_session(sparse_spec, z=z_np, restore=path, device="cpu") as s:
        (cpu_rec,) = s.step(1)
    card_rec = reps["sparse_allgather"].records[SESSION_SAVE_AT]
    check(cpu_rec.sent_bits == card_rec.sent_bits
          and _norms_close([cpu_rec.grad_norm], [card_rec.grad_norm]),
          f"sharded FNLS1 on the CPU: round {SESSION_SAVE_AT} {cpu_rec} vs {card_rec}")
    emit({"phase": "sharded", "part": "d", "saved_at": SESSION_SAVE_AT,
          "stepped_bitwise": True, "restored_bitwise": True, "fnls1_bytes": path.stat().st_size,
          "fnls1_round_trip_byte_identical": True,
          "cpu_resumed_round": {"grad_norm": cpu_rec.grad_norm, "card": card_rec.grad_norm}})
    path.unlink()
    again.unlink()

    # the index form at the sparse path's shape: all the clients' round-1 corrections
    u = (logreg_oracles_packed(shard_problem(z_np, device=dev), x1, cfg.lam)[2] - h1).contiguous()
    got, want = tcs.select_topk_idx_cuda(u, k), tcs.select_topk_idx_plain(u, k)
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          f"select_topk_idx: sent or idx differ from the plain version at ({n_clients}, {t_len})")
    check(bits_equal(got[0], want[0]), "select_topk_idx: u_hat differs at the sharded shape")
    keys = u.abs().float()
    ms = median_ms({
        "kernel": lambda: tcs.select_topk_idx_cuda(u, k),
        "plain": lambda: tcs.select_topk_idx_plain(u, k),
        "dense_form": lambda: tcs.select_topk_cuda(u, k),
        "library": lambda: torch.topk(keys, k, dim=-1),
    })
    bnd = bound(u.numel() * 16 + n_clients * (k * 4 + 4), SELECT_OPS_PER_KEY * u.numel(),
                CUDA_CORE_32BIT_OPS)
    out["idx_batched"] = {"shape": [n_clients, t_len], "k": k,
                          "max_abs_err": (got[0] - want[0]).abs().max().item(), **ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1]}
    del u, keys, got, want, x1, h1
    emit({"phase": "sharded", "part": "index_form_batched", **out["idx_batched"],
          "note": f"ms per call: median over {TIMED_REPS} event pairs around {CALLS_PER_EVENT} "
                  "calls; dense_form = select_topk on the same rows; library = torch.topk on "
                  "the same f32 keys"})

    collective_bytes = {  # per rank per round
        "dense_psum": {"all_reduce_f64": (t_len + d + 2) * 8, "all_reduce_i64": 3 * 8},
        "sparse_allgather": {"all_gather_idx_i32": n_clients * k * 4,
                             "all_gather_vals_f64": n_clients * k * 8,
                             "all_reduce_f64": (d + 2) * 8, "all_reduce_i64": 3 * 8},
    }
    emit({"phase": "sharded", "part": "summary",
          "ms_per_round": {agg: r.wall_time_s / r.rounds * 1e3 for agg, r in reps.items()},
          "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
          "phase4_local_ms_per_round": local_ms_per_round,
          "sharded_uplink_bits": {agg: sharded_uplink_bits(agg, t_len, k, n_clients)
                                  for agg in collective_bytes},
          "collective_bytes_per_rank": collective_bytes,
          "seconds": time.perf_counter() - t_phase,
          "note": "a world of one: each collective is a copy on the card, so the phase "
                  "measures the port's path, not a network"})
    torch.distributed.destroy_process_group()  # the world of one ends with the phase
    return out


def main() -> int:
    import torch

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
    from repro_torch.compressors.core import upload_draws
    from repro_torch.compressors.select import randseqk_window_mask, rank_keys
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.core.fednl_pp import fednl_pp_init, make_fednl_pp_round
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.compressor_select import (
        keys_in_shared_memory,
        select_topk_by_keys_cuda,
        select_topk_by_keys_plain,
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
        syrk_l2_bytes,
        syrk_schedule,
    )
    from repro_torch.kernels.threefry import threefry_uniform_cuda, threefry_uniform_plain
    from repro_torch.linalg import triu_size
    from repro_torch.models import cast_for_compute, init_decode_cache, lm_decode_step
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
    # the shared-z form of the sweep's group: 12 specs' hw on one z, client c
    # reading z[c mod 142]; against the plain version, and bit for bit against
    # the first form on z repeated
    hw_group = torch.as_tensor(
        rng.uniform(0.0, 0.25, size=(12 * n_clients, n_i)) / n_i, dtype=torch.float64, device=dev)
    h_group = hessian_syrk_packed_cuda(z, hw_group, cfg.lam)
    h_group_plain = hessian_syrk_packed_plain(z, hw_group, cfg.lam)
    group_scale = hessian_syrk_packed_plain(z.abs(), hw_group.abs(), 0.0).abs().max().item()
    syrk_group_err = (h_group - h_group_plain).abs().max().item()
    check(syrk_group_err <= SYRK_TOL * group_scale,
          f"SYRK shared-z error {syrk_group_err} > {SYRK_TOL} * {group_scale}")
    h_repeated = hessian_syrk_packed_cuda(z.repeat(12, 1, 1), hw_group, cfg.lam)
    check(bits_equal(h_group, h_repeated), "SYRK shared z differs from z repeated")
    del hw_group, h_group, h_group_plain, h_repeated

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
            "shared_z": {"clients": 12 * n_clients, "z_clients": n_clients,
                         "max_abs_err": syrk_group_err, "rel_err": syrk_group_err / group_scale,
                         "bit_exact_vs_z_repeated": True},
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

    # the threefry kernel: the round's real client keys, T = 1, one client
    def keys_on_card(keys_np):
        return torch.as_tensor(np.ascontiguousarray(keys_np).view(np.int32), device=dev)

    wide_keys = prng.split(prng.prng_key(7), 1000)
    threefry_cases = {  # name: (keys, t)
        "w8a_round0": (round_keys[0], t_len),
        "w8a_round1": (round_keys[1], t_len),
        "t_is_1": (round_keys[0], 1),
        "one_client": (round_keys[1][:1], t_len),
        "many_clients_t_3000": (wide_keys, 3000),
    }
    threefry_report, threefry_err = {}, {torch.float32: 0.0, torch.float64: 0.0}
    for name, (keys_np, tt) in threefry_cases.items():
        kt = keys_on_card(keys_np)
        for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
            got = threefry_uniform_cuda(kt, tt, dtype)
            want = threefry_uniform_plain(kt, tt, dtype)
            torch.cuda.synchronize()
            check(got.shape == (keys_np.shape[0], tt) and got.dtype == dtype,
                  f"threefry {name}: {tuple(got.shape)} {got.dtype}")
            check(torch.equal(got.view(bits), want.view(bits)),
                  f"threefry {name} {dtype}: differs from the plain version")
            check(bool((got >= 0).all()) and bool((got < 1).all()), f"threefry {name}: out of [0, 1)")
            threefry_err[dtype] = max(threefry_err[dtype], (got - want).abs().max().item())
        threefry_report[name] = [keys_np.shape[0], tt]
    # against the host generator too, on two clients of the round
    host = prng.uniform(round_keys[0][:2], (t_len,), np.float32)
    card = threefry_uniform_cuda(keys_on_card(round_keys[0][:2]), t_len, torch.float32).cpu().numpy()
    check(np.array_equal(host.view(np.int32), card.view(np.int32)), "threefry vs prng.uniform")

    # TopK by keys: the round's real uniforms, ties at the k-th key, k = 1, k = T
    unif0 = threefry_uniform_cuda(keys_on_card(round_keys[0]), t_len, torch.float32)
    tie_keys = torch.as_tensor(
        (rng.integers(0, 16, size=(n_clients, t_len)) / 16).astype(np.float32), device=dev)
    by_keys_cases = {  # name: (u, keys, k)
        "round0_uniforms": (delta1, unif0, k),
        "ties_at_kth_key": (delta1, tie_keys, k),
        "k_is_1": (delta1, unif0, 1),
        "k_is_T": (delta1, unif0, t_len),
        "keys_in_device_memory": (
            torch.as_tensor(rng.standard_normal((4, d350)), device=dev),
            threefry_uniform_cuda(keys_on_card(round_keys[1][:4]), d350, torch.float32), 8 * 350),
    }
    tk = tie_keys.cpu().numpy()
    kth = -np.sort(-tk, axis=1)[:, k - 1]
    check(bool(np.all((tk == kth[:, None]).sum(1) > k - (tk > kth[:, None]).sum(1))),
          "the tie fixture has no tie across the k-th key")
    by_keys_err = 0.0
    for name, (u, keys, kk) in by_keys_cases.items():
        got, sent = select_topk_by_keys_cuda(u.contiguous(), keys.contiguous(), kk)
        want, sent_want = select_topk_by_keys_plain(u, keys, kk)
        check(bits_equal(got, want), f"TopK by keys {name}: u_hat differs from the plain version")
        check(torch.equal(sent, sent_want), f"TopK by keys {name}: sent differs")
        by_keys_err = max(by_keys_err, (got - want).abs().max().item())
    torch.cuda.synchronize()
    emit({
        "phase": "kernels",
        "threefry_uniform": {"cases": threefry_report, "dtypes": ["float32", "float64"],
                             "bit_exact": True, "host_generator_bit_exact": True},
        "select_topk_by_keys": {"cases": sorted(by_keys_cases), "bit_exact": True,
                                "max_abs_err": by_keys_err},
    })

    # the sweep's shapes (phase 8): a branch's 4 specs x 142 rows of the
    # group's (12 * 142, T) delta, as the round takes them -- a slice at the
    # branch's offset (the group is ordered by branch) or gathered by
    # index_select (any other order) -- and the threefry uniforms of the 568
    # clients of 4 specs (seeds 0-3, round 0, the keys split as the round
    # splits them)
    tie_block = torch.as_tensor(near_tie_rows(n_clients, t_len, 12), device=dev)
    group_rows = torch.cat([(delta1 if s % 2 == 0 else tie_block) * (1.0 + s / 8)
                            for s in range(12)])
    per_branch = 4 * n_clients
    branch_rows = {f"rows_{lo}_to_{lo + per_branch}": group_rows[lo:lo + per_branch]
                   for lo in range(0, 12 * n_clients, per_branch)}
    gathered = (np.arange(1, 12, 3)[:, None] * n_clients + np.arange(n_clients)).reshape(-1)
    branch_rows["index_select_specs_1_4_7_10"] = group_rows.index_select(
        0, torch.as_tensor(gathered, device=dev))
    spec_keys = np.stack([prng.prng_key(s) for s in range(4)])
    sweep_keys = prng.split(prng.split(spec_keys, 2)[:, 1], n_clients).reshape(-1, 2)
    sweep_starts = torch.as_tensor(prng.randint(sweep_keys, 0, t_len), dtype=torch.int64, device=dev)
    for name, u in branch_rows.items():
        check(u.shape == (per_branch, t_len), f"sweep rows {name}: {tuple(u.shape)}")
        got, sent = select_topk_cuda(u, k)
        want, sent_want = select_topk_plain(u, k)
        check(bits_equal(got, want) and torch.equal(sent, sent_want),
              f"TopK at the sweep's {name}: differs from the plain version")
        topk_err = max(topk_err, (got - want).abs().max().item())
        got, sent = select_randseqk_cuda(u, k, sweep_starts)
        want, sent_want = select_randseqk_plain(u, k, sweep_starts)
        check(bits_equal(got, want) and torch.equal(sent, sent_want),
              f"RandSeqK at the sweep's {name}: differs from the plain version")
        randseqk_err = max(randseqk_err, (got - want).abs().max().item())
    kt = keys_on_card(sweep_keys)
    for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
        got = threefry_uniform_cuda(kt, t_len, dtype)
        want = threefry_uniform_plain(kt, t_len, dtype)
        check(got.shape == (per_branch, t_len) and torch.equal(got.view(bits), want.view(bits)),
              f"threefry at the sweep's 568 clients {dtype}: differs from the plain version")
        threefry_err[dtype] = max(threefry_err[dtype], (got - want).abs().max().item())
    torch.cuda.synchronize()
    emit({
        "phase": "kernels", "sweep_shapes": {
            "rows": {name: list(u.shape) for name, u in branch_rows.items()},
            "select_topk_bit_exact": True, "select_randseqk_bit_exact": True,
            "threefry_uniform": {"clients": per_branch, "t": t_len,
                                 "dtypes": ["float32", "float64"], "bit_exact": True},
        },
    })
    del tie_block, group_rows, branch_rows, u, got, want
    del state0, state1, delta0, h_plain, tie_keys, wide_keys
    flash_report, flash_err = check_flash(dev, tfa)
    emit({"phase": "kernels", "flash_attention": flash_report})

    # --- 4 the main paths, the launch counts set to 0 before each ---------
    def main_path(label: str, path_spec, per_round: tuple[str, ...], cpu_rounds: int = 3):
        """solve(path_spec) on the card: each kernel of ``per_round`` launched
        once a round and once in the warm-up round, SYRK also once at init;
        the first ``cpu_rounds`` rounds against the same spec on the CPU."""
        pp = path_spec.algorithm == "fednl-pp"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rep = solve(path_spec)
        launches = launch_counts(ops)
        check(rep.x.shape == (d,) and bool(np.all(np.isfinite(rep.x))), f"{label}: x not finite")
        want = {name: 0 for name in launches}
        want.update({name: rep.rounds + 1 for name in per_round})
        want["hessian_syrk_packed"] = rep.rounds + 2
        check(launches == want,
              f"{label}: launches {launches}, want {want} for {rep.rounds} rounds + warm-up (+ init)")
        rep_cpu = solve(path_spec.replace(rounds=cpu_rounds, tol=0.0), device="cpu")
        check(list(rep.sent_bits[:cpu_rounds]) == list(rep_cpu.sent_bits),
              f"{label}: sent_bits {rep.sent_bits[:cpu_rounds]} vs CPU {rep_cpu.sent_bits}")
        out = {
            "phase": "main", "path": label, "device": rep.extras["device"], "rounds": rep.rounds,
            "sent_bits": rep.sent_bits.tolist(), "cpu_sent_bits_3": rep_cpu.sent_bits.tolist(),
        }
        if pp:
            xh, xh_cpu = rep.x_hist, rep_cpu.x_hist  # each round's model, norm-wise
            rel = np.linalg.norm(xh[:cpu_rounds] - xh_cpu, axis=1) / np.linalg.norm(xh_cpu, axis=1)
            check(bool(np.all(np.isfinite(xh))), f"{label}: models not finite")
            check(float(rel.max()) <= TRAJECTORY_RTOL, f"{label}: card vs CPU models differ: {rel.max()}")
            check(rep.participants[:cpu_rounds] == rep_cpu.participants,
                  f"{label}: the chosen clients differ from the CPU run's")
            check(all(len(set(p)) == path_spec.tau for p in rep.participants),
                  f"{label}: not {path_spec.tau} distinct clients a round")
            out.update(final_grad_norm=rep.final_grad_norm, x_rel_err_3=rel.tolist(),
                       participants_round0=rep.participants[0][:8], tau=rep.extras["tau"])
        else:
            gn = rep.grad_norms
            check(rep.rounds >= 3 and bool(np.all(np.isfinite(gn))), f"{label}: grad norms {gn}")
            check(gn[-1] < gn[0], f"{label}: grad norm did not fall: {gn[0]} -> {gn[-1]}")
            rel = np.abs(gn[:cpu_rounds] - rep_cpu.grad_norms) / rep_cpu.grad_norms
            check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{label}: card vs CPU grad norms differ: {rel}")
            out.update(grad_norms=gn.tolist(), cpu_grad_norms_3=rep_cpu.grad_norms.tolist(),
                       cpu_rel_err_3=rel.tolist())
            if path_spec.algorithm == "fednl-ls":
                check(list(rep.ls_steps[:cpu_rounds]) == list(rep_cpu.ls_steps),
                      f"{label}: ls_steps {rep.ls_steps[:cpu_rounds]} vs CPU {rep_cpu.ls_steps}")
                out.update(ls_steps=rep.ls_steps.tolist())
        out.update(
            init_time_s=rep.init_time_s, wall_time_s=rep.wall_time_s,
            ms_per_round=rep.wall_time_s / rep.rounds * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
        )
        emit(out)
        return rep, launches

    rep, launches = main_path(
        "w8a topk option B hess0=exact rounds<=50 tol=1e-12", spec, ("select_topk",))
    check(rep.grad_norms[-1] <= rep.grad_norms[0] * 1e-6, f"TopK grad norms {rep.grad_norms}")
    toplek_spec = spec.replace(compressor=CompressorSpec("toplek"))
    rep_le, launches_le = main_path(
        "w8a toplek option B hess0=exact rounds<=50 tol=1e-12", toplek_spec, ("select_toplek",))
    randseqk_spec = spec.replace(compressor=CompressorSpec("randseqk"), rounds=30, tol=0.0)
    rep_rs, launches_rs = main_path(
        "w8a randseqk option B hess0=exact rounds=30", randseqk_spec, ("select_randseqk",))
    check(rep_rs.rounds == 30, f"RandSeqK ran {rep_rs.rounds} rounds")
    randk_spec = spec.replace(compressor=CompressorSpec("randk"), rounds=30, tol=0.0)
    rep_rk, launches_rk = main_path(
        "w8a randk option B hess0=exact rounds=30", randk_spec,
        ("threefry_uniform", "threefry_uniform_float32", "select_topk_by_keys"))
    natural_spec = spec.replace(compressor=CompressorSpec("natural"), rounds=30, tol=0.0)
    rep_nat, launches_nat = main_path(
        "w8a natural option B hess0=exact rounds=30", natural_spec,
        ("threefry_uniform", "threefry_uniform_float64"))
    check(rep_rk.rounds == rep_nat.rounds == 30, "RandK and Natural run 30 rounds")
    ls_spec = spec.replace(algorithm="fednl-ls")
    rep_ls, launches_ls = main_path(
        "w8a fednl-ls topk option B hess0=exact rounds<=50 tol=1e-12", ls_spec, ("select_topk",))
    pp_spec = spec.replace(algorithm="fednl-pp", tau=PP_TAU, rounds=50, tol=0.0)
    rep_pp, launches_pp = main_path(
        f"w8a fednl-pp topk tau={PP_TAU} option B hess0=exact rounds=50", pp_spec,
        ("select_topk",))
    check(rep_pp.rounds == 50, f"PP ran {rep_pp.rounds} rounds")
    check(rep_pp.final_grad_norm < rep.grad_norms[0],
          f"PP: grad norm {rep_pp.final_grad_norm} not below the start's {rep.grad_norms[0]}")

    # --- 5 the LM path: granite-3-2b, the launch counts set to 0 before each -
    lm = lm_phase(dev, ops)

    # --- 6 times at the main paths' shapes -------------------------------------
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
    keys_round = keys_on_card(round_keys[1])
    threefry_ms = {
        name: median_ms({
            "kernel": lambda dt=dt: threefry_uniform_cuda(keys_round, t_len, dt),
            "plain": lambda dt=dt: threefry_uniform_plain(keys_round, t_len, dt),
            "library": lambda dt=dt: torch.rand((n_clients, t_len), dtype=dt, device=dev),
        })
        for name, dt in (("float32", torch.float32), ("float64", torch.float64))
    }
    unif_keys = threefry_uniform_cuda(keys_round, t_len, torch.float32)
    by_keys_ms = median_ms({
        "kernel": lambda: select_topk_by_keys_cuda(delta1, unif_keys, k),
        "plain": lambda: select_topk_by_keys_plain(delta1, unif_keys, k),
        "library": lambda: torch.topk(unif_keys, k, dim=-1),
    })
    fq, fk, fv = flash_inputs(dev, 1, PREFILL_SEQ, PREFILL_SEQ, 32, 8, 64, torch.bfloat16, 100)
    qt, kt, vt = (t.transpose(1, 2) for t in (fq, fk, fv))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        flash_ms = median_ms({
            "kernel": lambda: tfa.flash_attention_cuda(fq, fk, fv, causal=True),
            "plain": lambda: tfa.flash_attention_plain(fq, fk, fv, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
        }, reps=FLASH_TIMED_REPS, calls=1)
    # the (query, key) pairs that the causal mask leaves visible, over the heads
    visible = tfa.visible_pairs(PREFILL_SEQ, PREFILL_SEQ, True, None) * fq.shape[2]
    product_flops = 2 * fq.shape[3] * visible  # QK^T, and again each P.V product
    flash_bytes = (2 * fq.numel() + fk.numel() + fv.numel()) * fq.element_size()
    flash_parts = {  # ms
        "qk_bf16_tensor": product_flops / BF16_TENSOR_FLOPS * 1e3,
        "pv_three_bf16_products_tensor": 3 * product_flops / BF16_TENSOR_FLOPS * 1e3,
        "bytes": flash_bytes / HBM_BYTES_PER_S * 1e3,
        "exp_mufu": visible / MUFU_EXP_PER_S * 1e3,
        "f32_pipe_pv_reckoning": (product_flops / BF16_TENSOR_FLOPS
                                  + product_flops / CUDA_CORE_32BIT_OPS) * 1e3,
        "all_bf16_p_rounded": 2 * product_flops / BF16_TENSOR_FLOPS * 1e3,
    }
    flash_bound = bound(flash_bytes, 4 * product_flops, BF16_TENSOR_FLOPS)
    del fq, fk, fv, qt, kt, vt
    syrk_bound = bound(
        (z.numel() + hw.numel() + h_kernel.numel()) * 8,
        2 * n_i * t_len * n_clients,
        FP64_TENSOR_FLOPS,
    )
    topk_bound = bound(
        delta1.numel() * 8 * 2 + n_clients * 4,  # u read, u_hat written, sent
        SELECT_OPS_PER_KEY * delta1.numel(),
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
        SELECT_OPS_PER_KEY * delta1.numel() + n_clients * (p2 // 2) * sort_stages * 2,
        CUDA_CORE_32BIT_OPS,
    )
    draws = n_clients * t_len
    threefry_bound = {
        name: bound(n_clients * 8 + draws * size, THREEFRY_OPS_PER_ELEM * draws,
                    CUDA_CORE_32BIT_OPS)
        for name, size in (("float32", 4), ("float64", 8))
    }
    by_keys_bound = bound(
        # keys read, the k kept entries of u read, u_hat written, sent
        draws * 4 + n_clients * k * 8 + draws * 8 + n_clients * 4,
        SELECT_OPS_PER_KEY * draws,
        CUDA_CORE_32BIT_OPS,
    )
    syrk_ops = 2 * n_i * t_len * n_clients
    syrk_sched = syrk_schedule(d)
    syrk_tiles = sum(len(w) for *_, warps in syrk_sched for w in warps)
    syrk_l2 = syrk_l2_bytes(n_clients, n_i, d)
    emit({
        "phase": "times", "part": "hessian_syrk_packed", "shape": [n_clients, n_i, d],
        **syrk_build_facts(build, reports.get("hessian_syrk")),
        "blocks_per_client": len(syrk_sched), "dmma_tiles_per_client": syrk_tiles,
        # a block holds its slot until its busiest warp ends
        "busiest_warp_tiles_per_client": sum(max(map(len, w)) for *_, w in syrk_sched),
        "scheduled_over_exact_ops": syrk_tiles * 16 * 8 / t_len,
        "l2_bytes_reckoned": syrk_l2,
        "tflop_per_s_exact_triangle": syrk_ops / syrk_ms["kernel"] / 1e9,
        "l2_tb_per_s_implied": syrk_l2 / syrk_ms["kernel"] / 1e9,
        "bound_ms": syrk_bound[0], "bound_by": syrk_bound[1],
        "note": "l2_bytes_reckoned: Z's columns and hw that the schedule's blocks "
                "stage (kernels/hessian_syrk.py:syrk_l2_bytes)",
    })
    emit({"phase": "times", "hessian_syrk_packed": syrk_ms, "select_topk": topk_ms,
          "select_randseqk": randseqk_ms, "select_toplek": toplek_ms,
          "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                  f"{CALLS_PER_EVENT} back-to-back calls, the three in turns; "
                  "randseqk library = torch.where on a precomputed window mask; "
                  "toplek has no library call: ranking_only = torch.topk on the "
                  "f32 keys, the ranking part only"})
    emit({"phase": "times", "threefry_uniform": threefry_ms, "select_topk_by_keys": by_keys_ms,
          "shape": [n_clients, t_len], "k": k,
          "bound_ms": {"threefry_float32": threefry_bound["float32"],
                       "threefry_float64": threefry_bound["float64"],
                       "select_topk_by_keys": by_keys_bound},
          "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                  f"{CALLS_PER_EVENT} back-to-back calls, the three in turns; threefry "
                  "library = torch.rand of the same shape and type (another generator, "
                  "timed only); TopK by keys library = torch.topk on the same f32 keys"})
    emit({"phase": "times", "flash_attention": flash_ms,
          "shape": [1, PREFILL_SEQ, 32, 8, 64], "causal": True, "dtype": "bfloat16",
          "route": tfa.flash_route(torch.bfloat16, 64),
          "bound_ms": flash_bound[0], "bound_by": flash_bound[1],
          "bound_parts_ms": flash_parts, "visible_pairs": visible,
          "note": f"ms per call: median over {FLASH_TIMED_REPS} event pairs around one call, "
                  "the three in turns; bound = (QK^T + 3 P.V bf16 products) at 989 TFLOP/s; "
                  "library = F.scaled_dot_product_attention(is_causal, enable_gqa) on the "
                  "flash or memory-efficient backend, which rounds p to bf16 for P.V: the "
                  "same function at lower precision"})

    # --- 7 no host sync in a round; where the time goes (torch.profiler) ----
    pp_cfg = pp_spec.fednl_config()
    rounds_of = {  # path: (round function, initial state)
        "topk": (make_fednl_round(z, cfg), fednl_init(z, cfg)),
        "randk": (make_fednl_round(z, randk_spec.fednl_config()),
                  fednl_init(z, randk_spec.fednl_config())),
        "fednl-pp topk": (make_fednl_pp_round(z, pp_cfg, PP_TAU), fednl_pp_init(z, pp_cfg)),
    }
    for path, (round_fn, state) in rounds_of.items():
        warm, _ = round_fn(state)  # fills the caches (index tensors, kernels) first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, m = round_fn(warm)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        emit({"phase": "trace", "path": path, "sync_debug_mode": "error",
              "one_round_without_host_sync": True, "sent_bits": int(m.sent_bits)})
    topk_trace = trace_rounds(*rounds_of["topk"], 3)
    syrk_rows = [k for k in topk_trace.get("top_kernels", []) if "syrk" in k["name"]]
    emit({"phase": "trace", "path": "topk", **topk_trace,
          "syrk_ms_per_round": syrk_rows[0]["ms_per_round"] if syrk_rows else "not measured"})
    toplek_cfg = toplek_spec.fednl_config()
    emit({"phase": "trace", "path": "toplek",
          **trace_rounds(make_fednl_round(z, toplek_cfg), fednl_init(z, toplek_cfg), 3)})
    emit({"phase": "trace", "path": "randk", **trace_rounds(*rounds_of["randk"], 3)})
    natural_cfg = natural_spec.fednl_config()
    emit({"phase": "trace", "path": "natural",
          **trace_rounds(make_fednl_round(z, natural_cfg), fednl_init(z, natural_cfg), 3)})
    emit({"phase": "trace", "path": f"fednl-pp topk tau={PP_TAU}",
          **trace_rounds(*rounds_of["fednl-pp topk"], 3)})
    del rounds_of
    emit({"phase": "draws", **host_draw_ms(prng, upload_draws, n_clients, t_len, dev)})
    emit({"phase": "trace", "path": "granite-3-2b prefill_32k (B=1)",
          **trace(lambda: lm["prefill"](lm["params"], lm["batch"]), 1, "prefill")})
    serve_params = cast_for_compute(lm["params"])  # as the ServeEngine holds them
    decode = {"cache": init_decode_cache(lm["cfg"], 4, 128, dev)}
    step_tokens = torch.zeros((4, 1), dtype=torch.int64, device=dev)

    def decode_step():
        _, decode["cache"] = lm_decode_step(serve_params, lm["cfg"], decode["cache"], step_tokens)

    decode_step()  # warm-up
    emit({"phase": "trace", "path": "granite-3-2b decode step (B=4, max_len 128)",
          **trace(decode_step, 8, "step")})
    del serve_params, decode
    flash_launches = lm["launches"]["flash_attention"]
    flash_routes = lm["flash_routes"]
    del lm

    # --- 8 sweeps: the README's grid as one batched group ------------------
    sweep_launches, sweep = sweep_phase(ops)

    # --- 9 sessions: step, save, restore ------------------------------------
    session_phase()

    # --- 10 the wire stack: star-loopback, codecs, PP with faults, TCP -------
    star = star_phase(ops, dev)

    # --- 11 topologies: trees of stars, async, elastic, TCP tree, obs --------
    topo = topology_phase(ops, dev, star)
    del star["z_np"], star["topk_rep"]

    # --- 12 the serving engine and its gateway ------------------------------
    t_serve = time.perf_counter()
    serve = serve_phase(ops, dev, sweep)
    emit({"phase": "serve", "seconds": time.perf_counter() - t_serve})

    # --- 13 the sharded backend: a world of one on NCCL --------------------
    sharded = sharded_phase(ops, dev, rep.wall_time_s / rep.rounds * 1e3)

    kernels = [
        {
            "name": "hessian_syrk_packed", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hessian_syrk.cu",
            "replaces": "src/repro/kernels/hessian_syrk.py:64",
            "launches": launches["hessian_syrk_packed"], "max_abs_err": syrk_err,
            "sweep_launches": sweep_launches["hessian_syrk_packed"],
            "ms": syrk_ms["kernel"], "plain_ms": syrk_ms["plain"],
            "bound_ms": syrk_bound[0], "bound_by": syrk_bound[1],
            "library_ms": syrk_ms["library"],
        },
        {
            "name": "select_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:67",
            "launches": launches["select_topk"], "max_abs_err": topk_err,
            "sweep_launches": sweep_launches["select_topk"],
            "ms": topk_ms["kernel"], "plain_ms": topk_ms["plain"],
            "bound_ms": topk_bound[0], "bound_by": topk_bound[1],
            "library_ms": topk_ms["library"],
        },
        {
            "name": "select_randseqk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:87",
            "launches": launches_rs["select_randseqk"], "max_abs_err": randseqk_err,
            "sweep_launches": sweep_launches["select_randseqk"],
            "ms": randseqk_ms["kernel"], "plain_ms": randseqk_ms["plain"],
            "bound_ms": randseqk_bound[0], "bound_by": randseqk_bound[1],
            "library_ms": randseqk_ms["library"],
        },
        {
            "name": "select_toplek", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/kernels/compressor_select.py:106",
            "launches": launches_le["select_toplek"], "max_abs_err": toplek_err,
            "sweep_launches": sweep_launches["select_toplek"],
            "ms": toplek_ms["kernel"], "plain_ms": toplek_ms["plain"],
            "bound_ms": toplek_bound[0], "bound_by": toplek_bound[1],
            "library_ms": None,
        },
        {
            "name": "threefry_uniform_float32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": "src/repro/compressors/core.py:106 (jax.random.uniform on the "
                        "device; not a Pallas kernel)",
            "launches": launches_rk["threefry_uniform_float32"],
            "max_abs_err": threefry_err[torch.float32],
            "sweep_launches": sweep_launches["threefry_uniform_float32"],
            "ms": threefry_ms["float32"]["kernel"], "plain_ms": threefry_ms["float32"]["plain"],
            "bound_ms": threefry_bound["float32"][0], "bound_by": threefry_bound["float32"][1],
            "library_ms": threefry_ms["float32"]["library"],
        },
        {
            "name": "threefry_uniform_float64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": "src/repro/compressors/core.py:161 (jax.random.bernoulli's uniform on "
                        "the device; not a Pallas kernel)",
            "launches": launches_nat["threefry_uniform_float64"],
            "max_abs_err": threefry_err[torch.float64],
            "sweep_launches": sweep_launches["threefry_uniform_float64"],
            "ms": threefry_ms["float64"]["kernel"], "plain_ms": threefry_ms["float64"]["plain"],
            "bound_ms": threefry_bound["float64"][0], "bound_by": threefry_bound["float64"][1],
            "library_ms": threefry_ms["float64"]["library"],
        },
        {
            "name": "select_topk_by_keys", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": "src/repro/compressors/core.py:107 (randk's lax.top_k: the selection "
                        "of src/repro/kernels/compressor_select.py:67 on RandK's keys)",
            "launches": launches_rk["select_topk_by_keys"], "max_abs_err": by_keys_err,
            "sweep_launches": sweep_launches["select_topk_by_keys"],
            "ms": by_keys_ms["kernel"], "plain_ms": by_keys_ms["plain"],
            "bound_ms": by_keys_bound[0], "bound_by": by_keys_bound[1],
            "library_ms": by_keys_ms["library"],
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "kernels": {"wgmma": "flash_fwd_wgmma_kernel (bf16, head_dim 64 and 128)",
                        "simt": "flash_fwd_kernel (f32; bf16 at head_dim 16 and 32)"},
            "prefill_32k_routes": flash_routes,
            "launches": flash_launches, "max_abs_err": flash_err,
            "sweep_launches": sweep_launches["flash_attention"],
            "ms": flash_ms["kernel"], "plain_ms": flash_ms["plain"],
            "bound_ms": flash_bound[0], "bound_by": flash_bound[1],
            "library_ms": flash_ms["library"],
        },
    ]
    for name, launched, replaces in (
        ("select_topk_idx", star["topk_launches"]["select_topk_idx"],
         "src/repro/kernels/compressor_select.py:67 (select_topk_pallas's selection, with the "
         "index output of src/repro/compressors/core.py:184 topk_sparse)"),
        ("select_topk_by_keys_idx", star["by_keys_idx_launches"]["select_topk_by_keys_idx"],
         "src/repro/compressors/core.py:189 (randk_sparse's lax.top_k, and the RandK codec's "
         "PRG replay, src/repro/comm/wire.py:184)"),
        ("select_toplek_idx", star["toplek_launches"]["select_toplek_idx"],
         "src/repro/kernels/compressor_select.py:106 (select_toplek_pallas, with the index "
         "output of src/repro/compressors/core.py:204 toplek_sparse)"),
    ):
        times = star["idx_ms"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
            "replaces": replaces, "launches": launched, "max_abs_err": star["idx_err"][name],
            "ms": times["kernel"], "plain_ms": times["plain"], "dense_form_ms": times["dense_form"],
            "bound_ms": star["idx_bound"][name][0], "bound_by": star["idx_bound"][name][1],
            "library_ms": times.get("library"),
        })
    for entry in kernels:  # the star path's launches of the kernels it shares
        if entry["name"] in ("hessian_syrk_packed", "threefry_uniform_float32"):
            entry["star_launches"] = {
                "topk": star["topk_launches"].get(entry["name"], 0),
                "pp_randk": star["by_keys_idx_launches"].get(entry["name"], 0),
            }
    for entry in kernels:  # phase 11's launches, each part's counts set to 0 before it
        entry["topology_launches"] = {part: counts.get(entry["name"], 0)
                                      for part, counts in topo.items()}
    for entry in kernels:  # phase 12 (a): the engine under pressure, counts set to 0 before it
        entry["serve_launches"] = serve["launches"].get(entry["name"], 0)
    for entry in kernels:  # phase 13: each sharded path, its counts set to 0 before it
        entry["sharded_launches"] = {part: counts.get(entry["name"], 0)
                                     for part, counts in sharded["launches"].items()}
        if entry["name"] == "select_topk_idx":  # the sparse path's (142, T) shape
            entry["sharded_shape"] = sharded["idx_batched"]
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
