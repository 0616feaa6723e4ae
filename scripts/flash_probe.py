#!/usr/bin/env python3
"""The port's flash kernel at head_dim 256 and variants of it, on one NVIDIA GPU.

    python3 scripts/flash_probe.py [--baseline FILE] [--baseline-bwd FILE]

Runs from the root of a checkout on a machine with a card and nvcc; imports
``repro_torch`` from ``src/`` and nothing of ``repro`` or JAX.  Prints one
JSON line per measurement, then the card's name and power limit.

  build    src/repro_torch/kernels/csrc/flash_attention.cu and variants of
           it, built from the same text with one change each, into
           build/flash_probe/ (one nvcc each, in parallel); ptxas's
           registers, spills and wgmma warnings for each head_dim-256
           instantiation:
             kernel           the source as it is: each consumer computes
                              the whole S; 3 stages, 4 P.V batches
             dh256_stages2    a 2-stage K/V ring at head_dim 256
             dh256_phases2    P.V of a 64-key tile in two batches of 32 keys
             dh256_half_s     S over half of head_dim: what the duplicated
                              S costs at most (wrong results; timed only)
             dh256_split_s    each consumer's S over its half of head_dim,
                              the two partial S exchanged through shared
                              memory (a barrier of the 256 consumer threads
                              a tile, two copies by tile parity) and added
                              in one order by both; 2 stages
             simt_bf16        the SIMT kernel also taking bf16 at head_dim
                              256 (the route before the wgmma kernel had it)
           and, with --baseline, another flash_attention.cu as it is (for
           example the parent commit's, unpacked by git archive), and whether
           each forward instantiation's SASS (cuobjdump beside nvcc,
           addresses and encodings dropped; wgmma and SIMT) is the same in
           both, the instantiations matched by kernel and template arguments
           after cu++filt: a kernel here with one more trailing bool
           argument than the baseline's (kTrain) is matched with it false,
           and its training instantiations (true) are listed apart
  check    each variant against the plain version (flash_attention_plain)
           within one bf16 ulp (taken at no less than 2**-14) at small shapes
           (GQA, windows, padding, Sq != Sk, a window without causality at
           an offset) and at recurrentgemma-2b's 32k layer (B 1, S 32,768,
           H 10, Kv 1, causal window 2048)
  times    CUDA-event medians of 5 event pairs around one call, the variants
           in turns, at recurrentgemma-2b's layer; with the source as it is
           also the head_dim-64 kernel at granite-3-2b's layer (H 32, Kv 8,
           causal), at the FedNL probe's backbone layer (B 512, S 16) and at
           B 64, S 64, and the head_dim-128 kernel at llava-next-mistral-7b's
           (H 32, Kv 8, causal window 4096) (TIMED_LAYERS), in turns with
           the baseline's, whose output on the same inputs each is held
           against: the elements whose bits differ, and the largest
           difference in bf16 ulps
  bwd      with --baseline-bwd, another flash_attention_bwd.cu (for example
           the parent commit's) built beside src/.../flash_attention_bwd.cu
           and variants of it (BWD_VARIANTS, one change each):
             bwd_four_groups  the split products one 16-row chunk a commit
                              group (the source: kSplitBatch = 2 chunks)
             bwd_one_group    all four chunks split, then issued as one
                              group
             bwd_trunc        P and dS split by truncation (each part the
                              next 8 significant bits: also exact)
             bwd_split<n>     head_dim 256: each key tile's (query head,
                              query tile) pairs split over a cluster of n
                              blocks, for n in SPLITS (1: no cluster; the
                              source's rule takes 4 at recurrentgemma-2b's
                              layer)
           (ptxas's registers and spills of each one's wgmma
           instantiations, and each head_dim-256 dkdv launch's split,
           blocks and clusters the card holds at once), and at each
           training layer of BWD_LAYERS (granite-3-2b's: B 2, S 4,096, H 32,
           Kv 8, dh 64, causal; recurrentgemma-2b's: H 10, Kv 1, dh 256,
           causal window 2048; bf16) every backward pair against the plain
           backward (bf16 ulps of each gradient's scale, and the share of
           its nonzero elements rounded otherwise, differ_share, within
           BWD_DIFFER_SHARE) and timed in turns (baseline, kernel, the
           variants, then the same in reverse; CUDA-event medians of
           BWD_REPS pairs around one call): the dq kernel, the dkdv kernel
           and the pair.  This source's pairs are its wgmma entry points;
           the baseline's is its wgmma pair at head_dim 64 and its SIMT
           pair (is_bf16 = 1) at 256, the parent commit's route there

Every source is compiled with src/repro_torch/kernels/csrc on the include
path, for hopper.cuh.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_probe"
REPS = 5
BWD_REPS = 11
SEQ = 32768
# the training layers: (B, S, H, Kv, dh), the causal window
BWD_LAYERS = {"granite_training_layer": ((2, 4096, 32, 8, 64), None),
              "recurrentgemma_training_layer": ((2, 4096, 10, 1, 256), 2048)}

SPLIT_S_EXCHANGE = """// S = S0 + S1 from the two consumers' partial S over their halves of
// head_dim: thread t of either consumer holds the same fragment positions;
// buf is [consumer][N / 4][128 threads] float4, two copies by tile parity.
template <int N>
__device__ __forceinline__ void exchange_s(float (&sc)[N], uint32_t buf, int cw, int tid) {
  const uint32_t mine = buf + (cw * (N / 4) * 128 + tid) * 16;
  const uint32_t theirs = buf + ((1 - cw) * (N / 4) * 128 + tid) * 16;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\\n" ::"r"(mine + j * 128 * 16),
                 "f"(sc[4 * j]), "f"(sc[4 * j + 1]), "f"(sc[4 * j + 2]), "f"(sc[4 * j + 3])
                 : "memory");
  asm volatile("bar.sync 1, 256;\\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float t[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\\n"
                 : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
                 : "r"(theirs + j * 128 * 16)
                 : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sc[4 * j + i] = cw == 0 ? __fadd_rn(sc[4 * j + i], t[i]) : __fadd_rn(t[i], sc[4 * j + i]);
  }
}

// The rest of one tile after S = Q K^T"""
SPLIT_S_LOOP = """      constexpr int kSteps = C::kColSplit ? DH / 32 : DH / 16;
      const int step0 = C::kColSplit ? kSteps * cw : 0;
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kSteps; ++kc) {
        const uint32_t off = ((step0 + kc) / 4) * C::kPanelBytes + (kc % 4) * 32;
        wgmma_ss(sc, smem_desc(q_wg + off), smem_desc(k_s + off), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if constexpr (C::kColSplit)
        exchange_s(sc, ring + C::kStages * C::kStageBytes + (it & 1) * 8 * kBQ * kBK, cw, tid);
"""
STAGES = ("static constexpr int kStages = DH == 128 ? 2 : 3;",
          "static constexpr int kStages = DH == 64 ? 3 : 2;")
VARIANTS = {  # name: [(text in flash_attention.cu, its replacement)]
    "kernel": [],
    "dh256_stages2": [STAGES],
    "dh256_phases2": [("static constexpr int kPhases = 4;",
                       "static constexpr int kPhases = kColSplit ? 2 : 4;")],
    "dh256_half_s": [("for (int kc = 0; kc < DH / 16; ++kc) {",
                      "for (int kc = 0; kc < (C::kColSplit ? DH / 32 : DH / 16); ++kc) {")],
    "dh256_split_s": [
        STAGES,
        ("static constexpr int kBarOffset = kTileBytes + kStages * kStageBytes;",
         "static constexpr int kBarOffset = kTileBytes + kStages * kStageBytes +\n"
         "                                    (kColSplit ? 16 * kBQ * kBK : 0);"),
        ("// The rest of one tile after S = Q K^T", SPLIT_S_EXCHANGE),
        ("""      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc / 4) * C::kPanelBytes + (kc % 4) * 32;
        wgmma_ss(sc, smem_desc(q_wg + off), smem_desc(k_s + off), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
""", SPLIT_S_LOOP),
    ],
    "simt_bf16": [("if constexpr (std::is_same<T, float>::value) {", "if constexpr (true) {")],
}
TIMED_ONLY = ("dh256_half_s",)
SPLIT3_TRUNC = """// split3 by truncation: each part the next 8 significant bits (exact)
__device__ __forceinline__ void split3_trunc(float x, float y, uint32_t& a1, uint32_t& a2,
                                             uint32_t& a3) {
  a1 = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
  x = __fsub_rn(x, __uint_as_float(a1 << 16));
  y = __fsub_rn(y, __uint_as_float(a1 & 0xffff0000u));
  a2 = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
  x = __fsub_rn(x, __uint_as_float(a2 << 16));
  y = __fsub_rn(y, __uint_as_float(a2 & 0xffff0000u));
  a3 = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

constexpr int kSplitBatch ="""
BATCH = "constexpr int kSplitBatch = 2;"
SPLITS = (1, 2, 3, 5, 8)  # the head_dim-256 dkdv kernel's other cluster sizes timed
BWD_VARIANTS = {  # name: [(text in flash_attention_bwd.cu, its replacement)]
    "bwd_four_groups": [(BATCH, "constexpr int kSplitBatch = 1;")],
    "bwd_one_group": [(BATCH, "constexpr int kSplitBatch = 4;")],
    "bwd_trunc": [("constexpr int kSplitBatch =", SPLIT3_TRUNC),
                  ("        split3(x[8 * c + 2 * j]", "        split3_trunc(x[8 * c + 2 * j]")],
    **{f"bwd_split{n}": [("  while (n < kMaxSplit && blocks * n < kSplitWaves * sms) n *= 2;",
                          f"  n = {n};")]
       for n in SPLITS},
}
SPLIT_ONLY = tuple(f"bwd_split{n}" for n in SPLITS)  # the source's kernel below head_dim 256
ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
)
# the backward's wgmma entry points: 8 pointers, batch .. head_dim, causal,
# window, pos_off, scale, stream; the SIMT ones take is_bf16 after head_dim
BWD_ARGTYPES = [ctypes.c_void_p] * 8 + ARGTYPES[4:]
BWD_SIMT_ARGTYPES = BWD_ARGTYPES[:14] + [ctypes.c_int] + BWD_ARGTYPES[14:]

# the layers timed with the source as it is (H 32, Kv 8, causal), in turns
# with the baseline's and held against its output bit for bit: (b, S,
# head_dim, window); the FedNL probe's backbone layer and B 64, S 64 take
# the packed grid (flash_fwd_grid), the 32k layers the grid of query tiles
TIMED_LAYERS = {
    "granite_32k_layer_dh64": (1, SEQ, 64, None),
    "llava_32k_layer_dh128": (1, SEQ, 128, 4096),
    "probe_backbone_layer_dh64": (512, 16, 64, None),
    "s64_b64_dh64": (64, 64, 64, None),
}
# (b, sq, sk, h, kv, causal, window, q_offset, k_offset)
CHECKS = {
    "rg_heads_window300_s1000": (1, 1000, 1000, 10, 1, True, 300, 0, 0),
    "kv2_window300_s1000": (2, 1000, 1000, 8, 2, True, 300, 0, 0),
    "kv2_b2_s300": (2, 300, 300, 4, 2, True, None, 0, 0),
    "noncausal_64x200": (1, 64, 200, 4, 4, False, None, 0, 0),
    "prompt_sq5": (1, 5, 5, 10, 1, True, None, 0, 0),
    "noncausal_window300_offset400": (1, 300, 700, 4, 1, False, 300, 500, 100),
    "recurrentgemma_32k_layer": (1, SEQ, SEQ, 10, 1, True, 2048, 0, 0),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reported(name: str, fn: str) -> bool:
    """The instantiations whose ptxas lines a build emits: the backward's
    wgmma kernels in a backward source, the head_dim-256 ones elsewhere."""
    return "flash_bwd" in fn and "wgmma" in fn if name.startswith("bwd") else "ILi256E" in fn


def build(kbuild, sources: dict[str, str]) -> dict[str, Path]:
    """One nvcc per source, all started together, with csrc/ on the include
    path; ptxas's report of the instantiations ``reported`` names emitted."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC), "-o",
             str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{report}")
        emit({"build": name, "ptxas": {fn: lines for fn, lines in kbuild.ptxas_entries(report).items()
                                       if reported(name, fn)}})
    return {name: OUT / f"{name}.so" for name in sources}


def sass_by_function(kbuild, lib: Path) -> dict[str, list[str]]:
    """The instructions of each function in a library, without their
    addresses and encodings."""
    cuobjdump = Path(kbuild.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = []
        elif name is not None and "/*" in line and ";" in line:
            out[name].append(line.split(";")[0].split("*/")[-1].strip())
    return out


def forward_instantiations(kbuild, sass: dict[str, list[str]]) -> dict[tuple, str]:
    """The flash forward kernels of ``sass`` by (kernel, template arguments),
    demangled by cu++filt beside nvcc."""
    names = sorted(fn for fn in sass if "flash_fwd" in fn)
    if not names:
        return {}
    filt = Path(kbuild.nvcc()).with_name("cu++filt")
    plain = subprocess.run([str(filt), *names], capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    out = {}
    for mangled, readable in zip(names, plain):
        found = re.search(r"(\w+)<([^<>]*)>\(", readable)
        if found:
            out[(found.group(1), tuple(a.strip() for a in found.group(2).split(",")))] = mangled
    return out


def compare_sass(kbuild, mine: dict, theirs: dict) -> dict:
    """Each baseline forward instantiation against this source's one with the
    same arguments (and kTrain false where this source has one more)."""
    ours, base = forward_instantiations(kbuild, mine), forward_instantiations(kbuild, theirs)
    pairs, training = {}, []
    for (kernel, args), fn in sorted(ours.items()):
        key = (kernel, args) if (kernel, args) in base else (kernel, args[:-1])
        if key not in base or (key[1] != args and args[-1] not in ("false", "(bool)0")):
            training.append(f"{kernel}<{', '.join(args)}>")
            continue
        pairs[f"{kernel}<{', '.join(key[1])}>"] = (mine[fn], theirs[base[key]])
    return {"sass_same_as_baseline": {label: a == b for label, (a, b) in pairs.items()},
            "instructions": {label: [len(a), len(b)] for label, (a, b) in pairs.items()},
            "not_in_this_source": sorted(f"{k}<{', '.join(a)}>" for k, a in base
                                         if f"{k}<{', '.join(a)}>" not in pairs),
            "only_in_this_source": training}


def median_ms(fns: dict, reps: int = REPS) -> dict[str, float]:
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in events.items()}


def backward_pair(lib: Path, wgmma: bool):
    """(dq, dkdv) callers of a backward library's bf16 entry points: the
    wgmma pair, or the SIMT pair."""
    import torch

    so = ctypes.CDLL(str(lib))
    fns = []
    for symbol in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        fn = getattr(so, f"{symbol}_wgmma" if wgmma else symbol)
        fn.argtypes = BWD_ARGTYPES if wgmma else BWD_SIMT_ARGTYPES
        fn.restype = ctypes.c_int
        fns.append(fn)

    def launch(fn, pointers, q, k, window):
        b, sq, h, dh = q.shape
        args = [t.data_ptr() for t in pointers] + [b, sq, k.shape[1], h, k.shape[2], dh]
        if not wgmma:
            args.append(1)
        code = fn(*args, 1, window or 0, 0, dh**-0.5, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{lib.name}: cudaError {code}")

    def dq(q, k, v, o, lse, do, dq_out, dsum, window):
        launch(fns[0], (q, k, v, o, lse, do, dq_out, dsum), q, k, window)

    def dkdv(q, k, v, lse, do, dsum, dk, dv, window):
        launch(fns[1], (q, k, v, lse, do, dsum, dk, dv), q, k, window)

    return dq, dkdv


def apply(name: str, text: str, subs, source: str) -> str:
    """``text`` with every occurrence of each (old, new) of ``subs`` replaced."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {source}")
        text = text.replace(old, new)
    return text


def bwd_against_baseline(kbuild, tfa, baseline_text: str) -> list[str]:
    """The backward pairs at each training layer of BWD_LAYERS (this source,
    its BWD_VARIANTS and the baseline): checked against the plain backward
    and timed in turns.  Returns the failed checks."""
    import torch

    text = (kbuild.CSRC / "flash_attention_bwd.cu").read_text()
    sources = {"bwd_kernel": text,
               **{name: apply(name, text, subs, "flash_attention_bwd.cu")
                  for name, subs in BWD_VARIANTS.items()},
               "bwd_baseline": baseline_text}
    libs = build(kbuild, sources)
    dev = torch.device("cuda")
    failed = []
    for layer, ((b, s, h, kv, dh), window) in BWD_LAYERS.items():
        gen = torch.Generator(device=dev).manual_seed(700)
        q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, s, kv, dh), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=True, window=window)
        o, lse = tfa.flash_attention_train_cuda(q, k, v, **kw)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        dq_out, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dsum = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        names = ["baseline", "kernel", *(n.removeprefix("bwd_") for n in BWD_VARIANTS
                                         if dh == 256 or n not in SPLIT_ONLY)]
        fns, routes, grids = {}, {}, {}
        for name in names:
            wgmma = not (name == "baseline" and dh == 256)
            routes[name] = "wgmma" if wgmma else "simt"
            dq, dkdv = backward_pair(libs[f"bwd_{name}"], wgmma)
            if dh == 256 and wgmma:
                grids[name] = tfa.flash_bwd_dkdv_grid(b, s, kv, lib=libs[f"bwd_{name}"])
            dq(q, k, v, o, lse, do, dq_out, dsum, window)
            dkdv(q, k, v, lse, do, dsum, dk, dv, window)
            torch.cuda.synchronize()
            ulps, shares = {}, {}
            for gname, got, w in zip(("dq", "dk", "dv"), (dq_out, dk, dv), want):
                scale = float(w.float().abs().max())
                ulps[gname] = (float((got.float() - w.float()).abs().max())
                               / 2.0 ** (math.frexp(scale)[1] - 8))
                shares[gname] = tfa.differ_share(got, w)
                if ulps[gname] > 2.0 or shares[gname] > tfa.BWD_DIFFER_SHARE:
                    failed.append(f"bwd {layer} {name} {gname}")
            emit({"bwd_check": name, "layer": layer, "route": routes[name],
                  "ulps_of_scale": ulps, "differ_share": shares})
            fns[f"{name}_dq"] = lambda dq=dq: dq(q, k, v, o, lse, do, dq_out, dsum, window)
            fns[f"{name}_dkdv"] = lambda dkdv=dkdv: dkdv(q, k, v, lse, do, dsum, dk, dv, window)
        turns = {}
        for turn in names + [f"{n}_again" for n in reversed(names)]:
            lib = turn.removesuffix("_again")
            turns[f"{turn}_dq"] = fns[f"{lib}_dq"]
            turns[f"{turn}_dkdv"] = fns[f"{lib}_dkdv"]
            turns[f"{turn}_pair"] = lambda lib=lib: (fns[f"{lib}_dq"](), fns[f"{lib}_dkdv"]())
        ms = median_ms(turns, BWD_REPS)
        pairs = tfa.visible_pairs(s, s, True, window) * h * b
        prod = 2 * dh * pairs
        emit({"times": f"{layer}_backward", "shape": [b, s, h, kv, dh], "causal": True,
              "window": window, "routes": routes, "dkdv_grid": grids or None, "ms": ms,
              "visible_pairs": pairs, "bound_ms": 11 * prod / 989e12 * 1e3,
              "two_kernel_floor_ms": 13 * prod / 989e12 * 1e3,
              "design_floor_ms": (16 if dh == 256 else 13) * prod / 989e12 * 1e3,
              "cuda_core_bound_ms": 5 * prod / 67e12 * 1e3,
              "speedup_pair": (ms["baseline_pair"] + ms["baseline_again_pair"])
              / (ms["kernel_pair"] + ms["kernel_again_pair"])})
        del q, k, v, do, o, lse, want, dq_out, dk, dv, dsum, fns, turns
        torch.cuda.empty_cache()
    return failed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as tfa

    text = (kbuild.CSRC / "flash_attention.cu").read_text()
    sources = {name: apply(name, text, subs, "flash_attention.cu")
               for name, subs in VARIANTS.items()}
    baseline = None
    if "--baseline" in sys.argv:
        baseline = Path(sys.argv[sys.argv.index("--baseline") + 1]).read_text()
        sources["baseline"] = baseline
    libs = build(kbuild, sources)
    dev = torch.device("cuda")

    def caller(name: str):
        lib = ctypes.CDLL(str(libs[name]))
        simt = name == "simt_bf16"
        fn = lib.flash_attention_fwd if simt else lib.flash_attention_fwd_wgmma
        fn.argtypes = ARGTYPES[:10] + [ctypes.c_int] + ARGTYPES[10:] if simt else ARGTYPES
        fn.restype = ctypes.c_int

        def call(q, k, v, causal, window, pos_off=0):
            out = torch.empty_like(q)
            b, sq, h, dh = q.shape
            args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
                    h, k.shape[2], dh]
            if simt:
                args.append(1)
            code = fn(*args, int(causal), window or 0, pos_off, dh**-0.5,
                      torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{name}: cudaError {code}")
            return out

        return call

    failed = []
    if "--baseline-bwd" in sys.argv:
        failed += bwd_against_baseline(
            kbuild, tfa, Path(sys.argv[sys.argv.index("--baseline-bwd") + 1]).read_text())

    calls = {name: caller(name) for name in VARIANTS}
    base_call = caller("baseline") if baseline is not None else None
    if baseline is not None:
        mine, theirs = (sass_by_function(kbuild, libs[n]) for n in ("kernel", "baseline"))
        emit(compare_sass(kbuild, mine, theirs))

    def inputs(b, sq, sk, h, kv, dh, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]

    for seed, (case, (b, sq, sk, h, kv, causal, window, q_off, k_off)) in enumerate(CHECKS.items()):
        q, k, v = inputs(b, sq, sk, h, kv, 256, 300 + seed)
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_off, k_offset=k_off)
        row = {"check": case, "shape": [b, sq, sk, h, kv, 256], "causal": causal,
               "window": window, "pos_off": q_off - k_off}
        for name, call in calls.items():
            if name in TIMED_ONLY:
                continue
            if name == "simt_bf16" and sq == SEQ:
                continue  # 37 ms a call on the CUDA cores: timed below, checked in chip_smoke
            got = call(q, k, v, causal, window, q_off - k_off)
            torch.cuda.synchronize()
            ulps = float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max())
            finite = bool(torch.isfinite(got).all())
            row[name] = {"max_ulps": ulps, "finite": finite,
                         "max_abs_err": float((got.float() - want.float()).abs().max())}
            if ulps > 1.0 or not finite:
                failed.append(f"{case} {name}")
        emit(row)
        del q, k, v, want

    q, k, v = inputs(1, SEQ, SEQ, 10, 1, 256, 101)
    ms = median_ms({name: (lambda call=call: call(q, k, v, True, 2048)) for name, call in calls.items()})
    visible = tfa.visible_pairs(SEQ, SEQ, True, 2048) * 10
    emit({"times": "recurrentgemma_32k_layer", "ms": ms, "visible_pairs": visible,
          "bound_ms": 4 * 2 * 256 * visible / 989e12 * 1e3})
    del q, k, v
    for case, (b, s, dh, window) in TIMED_LAYERS.items():
        q, k, v = inputs(b, s, s, 32, 8, dh, 100)
        got = calls["kernel"](q, k, v, True, window)
        want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
        ulps = float(tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR).max())
        if ulps > 1.0:
            failed.append(case)
        row = {"times": case, "shape": [b, s, s, 32, 8, dh], "window": window, "max_ulps": ulps}
        fns = {"kernel": lambda: calls["kernel"](q, k, v, True, window)}
        if base_call is not None:  # baseline, kernel, kernel, baseline
            base = base_call(q, k, v, True, window)
            torch.cuda.synchronize()
            row["vs_baseline"] = {
                "bits_differ": int((got.view(torch.int16) != base.view(torch.int16)).sum()),
                "max_ulps": float(tfa.bf16_ulps(got, base, tfa.BF16_ULP_FLOOR).max()),
                "baseline_max_ulps": float(tfa.bf16_ulps(base, want, tfa.BF16_ULP_FLOOR).max())}
            fns = {"baseline": lambda: base_call(q, k, v, True, window), **fns,
                   "kernel_again": fns["kernel"],
                   "baseline_again": lambda: base_call(q, k, v, True, window)}
        visible = tfa.visible_pairs(s, s, True, window) * 32 * b
        emit({**row, "ms": median_ms(fns), "bound_ms": 4 * 2 * dh * visible / 989e12 * 1e3})
        del q, k, v, got, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if failed:
        print(f"flash_probe: beyond one bf16 ulp: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
