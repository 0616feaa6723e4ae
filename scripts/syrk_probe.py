#!/usr/bin/env python3
"""Where the time of the port's SYRK kernel goes, on one NVIDIA GPU.

    python3 scripts/syrk_probe.py

Runs from the root of a checkout on a machine with a card and nvcc; imports
``repro_torch`` from ``src/`` and nothing of ``repro`` or JAX.  Prints one
JSON line per measurement, then the card's name and power limit.

  dmma     the FP64 tensor-core rate of each mma.sync f64 shape (m8n8k4,
           m16n8k4, m16n8k8, m16n8k16): 528 blocks of 256 threads, 8
           independent accumulators a warp, no memory traffic
  syrk     src/repro_torch/kernels/csrc/hessian_syrk.cu and variants of it,
           built from the same text with one change each, at w8a's shape
           (142, 348, 301), beside the plain version and torch.bmm (the full
           square), all in turns in one process: CUDA-event medians of 11
           event pairs around 10 calls.  The variants that compute the same
           function are held to the plain version (1e-13 of
           max(|Z|^T |h| |Z|)); the others only time a part of the kernel:
             wide_only        no 16 x 32 warp layout for narrow blocks
             masked_only      every warp's products predicated by its tile
                              mask, none on the all-tiles path
             chunk16_stages4  a 4-stage ring of 16-sample chunks
             loads_only       the copies, no products
             compute_only     the products on whatever shared memory holds
             no_stores        no epilogue stores
             no_barrier       no barrier per chunk (races; timing only)

The variants are built into build/syrk_probe/ (one nvcc each, in parallel).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "syrk_probe"
SYRK_TOL = 1e-13
REPS, CALLS = 11, 10

DMMA_SOURCE = r"""
#include <cuda_runtime.h>
template <int S> __device__ __forceinline__ void mma(double (&c)[4], const double (&a)[8],
                                                     const double (&b)[4]);
template <> __device__ __forceinline__ void mma<0>(double (&c)[4], const double (&a)[8],
                                                   const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1>(double (&c)[4], const double (&a)[8],
                                                   const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
               "{%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<2>(double (&c)[4], const double (&a)[8],
                                                   const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
               "{%8,%9}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<3>(double (&c)[4], const double (&a)[8],
                                                   const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                 "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int S> __global__ void rate(double* out, int iters) {
  double a[8], b[4], c[8][4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = threadIdx.x * 2e-3 + i;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) c[j][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma<S>(c[j], a, b);
  }
  double s = 0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += c[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int shape, void* out, int blocks, int threads, int iters) {
  double* o = static_cast<double*>(out);
  if (shape == 0) rate<0><<<blocks, threads>>>(o, iters);
  if (shape == 1) rate<1><<<blocks, threads>>>(o, iters);
  if (shape == 2) rate<2><<<blocks, threads>>>(o, iters);
  if (shape == 3) rate<3><<<blocks, threads>>>(o, iters);
  return cudaGetLastError();
}
"""
DMMA_SHAPES = {"m8n8k4": (0, 8 * 8 * 4), "m16n8k4": (1, 16 * 8 * 4),
               "m16n8k8": (2, 16 * 8 * 8), "m16n8k16": (3, 16 * 8 * 16)}

# one change each to the kernel's text: (anchor, replacement)
_MULTIPLY = "    if (mask == 0xffu) {"
_COPY = 'asm volatile("cp.async.ca.shared.global'
_STORE = "if (q < d && q >= r) oc[row_off + q]"
_BARRIER = "    __syncthreads();               // everyone's"
VARIANTS = {
    "kernel": [],
    "wide_only": [("const bool narrow = d - q0 <= kNarrowCols;", "const bool narrow = false;")],
    "chunk16_stages4": [("kChunk = 32;", "kChunk = 16;"), ("kStages = 2;", "kStages = 4;")],
    "masked_only": [(_MULTIPLY, "    if (d < 0) {"), ("    } else if (narrow && mask == 0xfu) {",
                                                    "    } else if (d < 0) {")],
    "loads_only": [(_MULTIPLY, "    if (d < 0) {"), ("    } else if (narrow && mask == 0xfu) {",
                                                   "    } else if (d < 0) {"),
                   ("    } else if (narrow && mask != 0) {", "    } else if (d < 0) {"),
                   ("    } else if (mask != 0) {", "    } else if (d < 0) {")],
    "compute_only": [(_COPY, "if (0) " + _COPY)],
    "no_stores": [(_STORE, "if (q < d && q >= r && lam == 12345.0) oc[row_off + q]")],
    "no_barrier": [(_BARRIER, "    if (d < 0) __syncthreads();  // everyone's")],
}
SAME_FUNCTION = ("kernel", "wide_only", "masked_only", "chunk16_stages4")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(nvcc: str, flags, sources: dict[str, str]) -> dict[str, Path]:
    """One nvcc per source, all started together; ptxas's report emitted."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen([nvcc, *flags, "-o", str(OUT / f"{name}.so"), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{report}")
        emit({"build": name, "ptxas": [ln.strip() for ln in report.splitlines()
                                       if "registers" in ln or "spill" in ln]})
    return {name: OUT / f"{name}.so" for name in sources}


def median_ms(fns: dict) -> dict[str, float]:
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(REPS):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in pairs) / CALLS
            for name, pairs in events.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("syrk_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.hessian_syrk import hessian_syrk_packed_plain, syrk_l2_bytes

    kernel_src = (kbuild.CSRC / "hessian_syrk.cu").read_text()
    sources = {"dmma_rate": DMMA_SOURCE}
    for name, subs in VARIANTS.items():
        text = kernel_src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in hessian_syrk.cu")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(kbuild.nvcc(), kbuild.NVCC_FLAGS, sources)
    dev = torch.device("cuda")

    lib = ctypes.CDLL(str(libs["dmma_rate"]))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    blocks, threads, iters = 132 * 4, 256, 2000
    out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)
    for name, (shape, mnk) in DMMA_SHAPES.items():
        check = lib.run(shape, out.data_ptr(), blocks, threads, iters)
        if check != 0:
            raise RuntimeError(f"dmma {name}: cudaError {check}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.run(shape, out.data_ptr(), blocks, threads, iters)
        end.record()
        torch.cuda.synchronize()
        flops = blocks * threads // 32 * iters * 8 * 2 * mnk
        emit({"dmma": name, "tflop_per_s": flops / start.elapsed_time(end) / 1e9,
              "blocks": blocks, "threads": threads})

    n_clients, n, d = 142, 348, 301
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.standard_normal((n_clients, n, d)) * (rng.random((n_clients, n, d)) < 0.3),
                        device=dev)
    sigma = rng.uniform(size=(n_clients, n))
    hw = torch.as_tensor(sigma * (1 - sigma) / n, device=dev)
    want = hessian_syrk_packed_plain(z, hw, 1e-3)
    scale = hessian_syrk_packed_plain(z.abs(), hw.abs(), 0.0).abs().max().item()
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_void_p]
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(libs[name])).syrk_packed_f64
        fn.argtypes = argtypes

        def call(fn=fn, name=name):
            got = torch.empty_like(want)
            check = fn(z.data_ptr(), hw.data_ptr(), got.data_ptr(), n_clients, n, d, 1e-3,
                       torch.cuda.current_stream().cuda_stream)
            if check != 0:
                raise RuntimeError(f"{name}: cudaError {check}")
            return got

        if name in SAME_FUNCTION:
            err = (call() - want).abs().max().item()
            if err > SYRK_TOL * scale:
                raise RuntimeError(f"{name}: error {err} > {SYRK_TOL} * {scale}")
            emit({"syrk": name, "max_abs_err": err, "scale": scale})
        fns[name] = call
    zs = hw[..., None] * z
    fns["plain"] = lambda: hessian_syrk_packed_plain(z, hw, 1e-3)
    fns["torch_bmm_full_square"] = lambda: torch.bmm(z.mT, zs)
    ms = median_ms(fns)
    emit({"syrk_ms": ms, "shape": [n_clients, n, d], "l2_bytes": syrk_l2_bytes(n_clients, n, d),
          "exact_triangle_flop": 2 * n * (d * (d + 1) // 2) * n_clients})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
