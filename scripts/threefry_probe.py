#!/usr/bin/env python3
"""The port's threefry kernel, variants of it and another threefry.cu, on one NVIDIA GPU.

    python3 scripts/threefry_probe.py [--baseline FILE ...] [--reps N] [--passes N]

Runs from the root of a checkout on a machine with a card and nvcc; imports
``repro_torch`` from ``src/`` and chip_smoke.py's SASS parser and constants
(by path), nothing of ``repro`` or JAX.  Prints one JSON line per
measurement, then the card's name and power limit.

  build    src/repro_torch/kernels/csrc/threefry.cu and variants of it, each
           the same text with one of the design's constants (the lines at
           the top of the file) set otherwise, into build/threefry_probe/
           (one nvcc each, in parallel), with ptxas's registers and spills:
             counters_<n>    n counters a thread on the main route (1, 2, 4)
             no_small_route, small_route_to_8  the main route at every
                             shape, or the small route (one element a
                             thread) up to 8 elements a resident thread
             scalar_stores   one 4- or 8-byte store an element, a warp's
                             neighbouring elements kBlock apart a thread
             steer, no_steer the hash's adds (the key injections' too) and
                             the float's words as IMAD, or as nvcc chooses
                             (IADD3, SHF, LOP3 and some IMAD)
             fma_rot_<n>     n of the 20 rotations on the FMA pipe as one
                             IMAD.WIDE each, the rest a funnel shift
           (a variant whose text equals the source's is not built) and, with
           --baseline (again for more), another threefry.cu as it is (for
           example the parent commit's, unpacked by git archive); its C
           entry points must be the source's
  rates    the integer pipes' rates on the card it runs on: kernels of 8
           independent chains a thread of one instruction each (IMAD.WIDE,
           IMAD, IMAD.HI, LOP3, SHF), of two halves (IMAD.WIDE, IMAD or
           IMAD.HI beside LOP3; IMAD.WIDE beside IMAD) and of an add of an
           immediate then a LOP3 (VIADD's pipe), 8 blocks of 256 threads a
           SM, as instructions a clock a SM at nvidia-smi's highest SM
           clock, each loop's SASS opcodes beside
  plan     the source's cut of each shape: counters a thread, elements a
           run, tiles a row, tiles, tail slots, blocks, resident blocks a
           SM, the small route
  check    every build against threefry_uniform_plain, bit for bit, f32 and
           f64, at the timed shapes and at CHECK_SHAPES (T mod 4 = 1, 2, 3;
           T below a run; a head and a tail on every row)
  sass     each build's main loop as compiled (chip_smoke.threefry_loop_facts):
           integer instructions an element on each pipe, stores, tail loops
  times    CUDA-event medians of --reps event pairs around a CUDA graph of
           CALLS launches of a build's C entry point on preallocated output
           (device time, no host gaps), every build in turns, forward then
           reversed, at SHAPES, f32 and f64, in --passes passes over the
           shapes (their spread), beside threefry's bound
           (chip_smoke's: the least integer instructions over the two
           integer pipes, or the stores)
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "threefry_probe"
CALLS = 20
# the timed shapes: w8a's round, the sweep's 568 rows, the star's one
# client, a9a's and phishing's rounds
SHAPES = {"w8a_round": (142, 45451), "sweep_rows": (568, 45451),
          "star_one_client": (1, 45451), "a9a_round": (142, 7750),
          "phishing_round": (142, 2415)}
# checked only: T mod 4 = 1, 2, 3 on the main route; T below a thread's run
# on the small route and (main_t_*, enough rows) on the main one; a head or
# a tail on every row; rows past the first 2**16
CHECK_SHAPES = {"t_mod4_1": (142, 45449), "t_mod4_2": (142, 45450), "t_mod4_3": (300, 4099),
                "t_1": (1000, 1), "t_3": (1000, 3), "t_5": (300, 5), "t_6": (300, 6),
                "main_t_3": (200000, 3), "main_t_5": (150000, 5), "main_t_6": (100000, 6),
                "edge_every_row": (300, 4097), "many_rows": (70000, 9)}
VARIANTS = {  # name: {constant: its value}
    "counters_1": {"kCounters": "1"},
    "counters_2": {"kCounters": "2"},
    "counters_4": {"kCounters": "4"},
    "no_small_route": {"kSmallPerThread": "0"},
    "small_route_to_8": {"kSmallPerThread": "8"},
    "scalar_stores": {"kVectorStores": "false"},
    "no_steer": {"kSteer": "false"},
    "steer": {"kSteer": "true"},
    **{f"fma_rot_{n}": {"kFmaRotations": f"0x{mask:05X}u"}
       for n, mask in ((0, 0x00000), (2, 0x01010), (5, 0x11111), (10, 0x55555))},
}
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)

RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int kChains = 8;
// one instruction a chain a step, each an asm volatile: op 0 IMAD.WIDE (a
// 64-bit chain w = lo(w) * p + w), 1 IMAD, 2 IMAD.HI, 3 LOP3, 4 SHF; in
// halves (odd chains the second): 5 IMAD.WIDE beside LOP3, 6 IMAD beside
// LOP3, 7 IMAD.WIDE beside IMAD, 8 IMAD.HI beside LOP3; 9 an add of an
// immediate then a LOP3 in each chain (ptxas joins a chain of adds alone)
template <int kOp>
__device__ __forceinline__ void step(uint32_t (&x)[kChains], unsigned long long (&w)[kChains],
                                     uint32_t p, uint32_t q) {
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    const int op = kOp < 5 || kOp == 9 ? kOp : i % 2 == 0 ? (kOp == 6 ? 1 : kOp == 8 ? 2 : 0)
                                                          : (kOp == 7 ? 1 : 3);
    if (op == 0) {
      asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w[i]) : "r"(static_cast<uint32_t>(w[i])),
                   "r"(p));
    } else if (op == 1) {
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(p), "r"(q));
    } else if (op == 2) {
      asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(p), "r"(q));
    } else if (op == 3) {
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x[i]) : "r"(p), "r"(q));
    } else if (op == 4) {
      asm volatile("shf.l.wrap.b32 %0, %0, %0, 13;" : "+r"(x[i]));
    } else {
      asm volatile("add.u32 %0, %0, 40503;" : "+r"(x[i]));
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x[i]) : "r"(p), "r"(q));
    }
  }
}
template <int kOp>
__global__ void __launch_bounds__(256) rate(uint32_t* out, int iters, uint32_t p, uint32_t q) {
  uint32_t x[kChains];
  unsigned long long w[kChains];
  for (int i = 0; i < kChains; ++i) {
    x[i] = threadIdx.x * 7919u + i;
    w[i] = (static_cast<unsigned long long>(blockIdx.x) << 32) | x[i];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) step<kOp>(x, w, p, q);
  }
  uint32_t s = 0;
  for (int i = 0; i < kChains; ++i) s ^= x[i] ^ static_cast<uint32_t>(w[i] >> 7);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int kOp>
int run_op(uint32_t* o, int blocks, int iters, unsigned p, unsigned q) {
  rate<kOp><<<blocks, 256>>>(o, iters, p, q);
  return 0;
}
extern "C" int run(int op, void* out, int blocks, int iters, unsigned p, unsigned q) {
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (op) {
    case 0: run_op<0>(o, blocks, iters, p, q); break;
    case 1: run_op<1>(o, blocks, iters, p, q); break;
    case 2: run_op<2>(o, blocks, iters, p, q); break;
    case 3: run_op<3>(o, blocks, iters, p, q); break;
    case 4: run_op<4>(o, blocks, iters, p, q); break;
    case 5: run_op<5>(o, blocks, iters, p, q); break;
    case 6: run_op<6>(o, blocks, iters, p, q); break;
    case 7: run_op<7>(o, blocks, iters, p, q); break;
    case 8: run_op<8>(o, blocks, iters, p, q); break;
    default: run_op<9>(o, blocks, iters, p, q); break;
  }
  return cudaGetLastError();
}
"""
RATE_OPS = ("imad_wide", "imad", "imad_hi", "lop3", "shf", "imad_wide_beside_lop3",
            "imad_beside_lop3", "imad_wide_beside_imad", "imad_hi_beside_lop3",
            "add_immediate_then_lop3")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_chip_smoke():
    """chip_smoke.py by its path (the SASS parser, the bound's constants)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant_text(source: str, values: dict[str, str]) -> str:
    for name, value in values.items():
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", source)
        if n != 1:
            raise RuntimeError(f"threefry.cu holds {n} definitions of {name}")
        source = text
    return source


def build(nvcc: str, flags, csrc: Path, sources: dict[str, str]) -> dict[str, Path]:
    """One nvcc per source, all started together; ptxas's report emitted."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, f"-I{csrc}", "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{report}")
        emit({"build": name, "ptxas": [ln.strip() for ln in report.splitlines()
                                       if "registers" in ln or "spill" in ln]})
    return {name: OUT / f"{name}.so" for name in sources}


def sass_text(nvcc: str, lib: Path) -> str | None:
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.is_file():
        return None
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def graph_ms(fns: dict, reps: int) -> tuple[dict[str, float], str]:
    """Each function CALLS times in one CUDA graph; the median over reps
    event pairs around a replay, the graphs in turns, forward then reversed.
    Where a launch cannot be captured, CALLS back-to-back calls instead (the
    host's launch time may then show): the second value says which."""
    import torch

    runs = {}
    try:
        side = torch.cuda.Stream()
        for name, fn in fns.items():
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(CALLS):
                    fn()
            runs[name] = graph.replay
        method = f"a CUDA graph of {CALLS} launches"
    except RuntimeError as err:
        torch.cuda.synchronize()
        emit({"graph_capture": "failed", "error": str(err)[:300]})

        def calls(fn):
            def run():
                for _ in range(CALLS):
                    fn()
            return run

        runs = {name: calls(fn) for name, fn in fns.items()}
        method = f"{CALLS} back-to-back calls"
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    order = list(runs)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name]()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in pairs) / CALLS
            for name, pairs in events.items()}, method


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, action="append", default=[],
                        help="another threefry.cu, built beside this one (again for more: "
                             "baseline, baseline_2, ...)")
    parser.add_argument("--reps", type=int, default=21, help="event pairs a build and shape")
    parser.add_argument("--passes", type=int, default=2,
                        help="passes over the timed shapes (their spread)")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("threefry_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.threefry import PLAN_FIELDS, threefry_uniform_plain

    cs = load_chip_smoke()
    source = (kbuild.CSRC / "threefry.cu").read_text()
    sources = {"kernel": source}
    for name, values in VARIANTS.items():
        text = variant_text(source, values)
        if text == source:
            emit({"variant": name, "note": "the source as it is: not built again"})
            continue
        sources[name] = text
    for i, path in enumerate(args.baseline):
        sources["baseline" if i == 0 else f"baseline_{i + 1}"] = path.read_text()
    sources["rates"] = RATE_SOURCE
    nvcc = kbuild.nvcc()
    libs = build(nvcc, kbuild.NVCC_FLAGS, kbuild.CSRC, sources)
    rates_lib = libs.pop("rates")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = cs.sm_clock_hz()

    # the integer pipes' rates
    rate = ctypes.CDLL(str(rates_lib)).run
    rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                     ctypes.c_uint]
    blocks, iters = sms * 8, 4096
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    rates = {}
    for op, name in enumerate(RATE_OPS):
        for _ in range(2):  # the first call warms up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            code = rate(op, sink.data_ptr(), blocks, iters, 0x2001, 0x9E3779B9)
            end.record()
            if code != 0:
                raise RuntimeError(f"rate {name}: cudaError {code}")
        torch.cuda.synchronize()
        instrs = blocks * 256 * iters * 8 * 8
        rates[name] = instrs / (start.elapsed_time(end) * 1e-3) / (sms * clock_hz)
    rate_sass = sass_text(nvcc, rates_lib)
    loops = {}
    if rate_sass is not None:
        for fn, lines in cs.sass_functions(rate_sass).items():
            op = re.search(r"rateILi(\d+)E", fn)
            if op:
                inner = cs.sass_loops(lines)["loops"]
                loops[RATE_OPS[int(op.group(1))]] = [lp["opcodes"] for lp in inner]
    emit({"rates": {"per_sm_clock": rates, "sm_clock_hz": clock_hz, "sms": sms,
                    "chains_a_thread": 8, "blocks": blocks, "loop_opcodes": loops,
                    "note": "thread instructions a clock a SM at the highest SM clock; "
                            "a pipe of 64 a clock a SM reads 64"}})

    # each build's C entry points
    fns = {}
    for name, lib in libs.items():
        cdll = ctypes.CDLL(str(lib))
        fns[name] = {}
        for dtype, symbol in ((torch.float32, "threefry_uniform_f32"),
                              (torch.float64, "threefry_uniform_f64")):
            fn = getattr(cdll, symbol)
            fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
            fns[name][dtype] = fn
    plan_fn = ctypes.CDLL(str(libs["kernel"])).threefry_uniform_plan
    plan_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]

    def launch(name, dtype, keys, out, t):
        code = fns[name][dtype](keys.data_ptr(), out.data_ptr(), keys.shape[0], t,
                                torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{name} {dtype}: cudaError {code}")

    def client_keys(n, seed):
        keys = prng.split(prng.split(prng.prng_key(seed), 2)[1], n)
        return torch.as_tensor(np.ascontiguousarray(keys).view(np.int32), device=dev)

    # the cut and the check
    for shape_name, (n, t) in {**SHAPES, **CHECK_SHAPES}.items():
        keys = client_keys(n, t)
        for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
            plan = np.zeros(len(PLAN_FIELDS), dtype=np.int64)
            code = plan_fn(int(dtype == torch.float64), n, t, plan.ctypes.data)
            if code != 0:
                raise RuntimeError(f"plan {shape_name}: cudaError {code}")
            want = threefry_uniform_plain(keys, t, dtype).view(bits)
            for name in fns:
                got = torch.full((n, t), float("nan"), dtype=dtype, device=dev)
                launch(name, dtype, keys, got, t)
                if not torch.equal(got.view(bits), want):
                    raise RuntimeError(f"{name} {dtype} at {shape_name} {(n, t)}: differs from "
                                       "the plain version")
            emit({"check": shape_name, "shape": [n, t], "dtype": str(dtype).removeprefix("torch."),
                  "bit_exact": sorted(fns), "plan": dict(zip(PLAN_FIELDS, plan.tolist()))})

    # the main loops as compiled
    for name, lib in libs.items():
        sass = sass_text(nvcc, lib)
        if sass is None:
            emit({"sass": name, "note": "not measured (no cuobjdump beside nvcc)"})
            continue
        facts = cs.threefry_loop_facts(sass)
        emit({"sass": name, **{key: {k: v for k, v in f.items() if k != "function"}
                               for key, f in facts.items()}})

    # times, every build in turns
    int_pipe_per_s = cs.INT32_PIPE_PER_SM_CLOCK * sms * clock_hz
    for pass_, (shape_name, (n, t)) in (
            (p, item) for p in range(args.passes) for item in SHAPES.items()):
        keys = client_keys(n, t)
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            dname = str(dtype).removeprefix("torch.")
            outs = {name: torch.empty((n, t), dtype=dtype, device=dev) for name in fns}
            ms, method = graph_ms(
                {name: (lambda name=name: launch(name, dtype, keys, outs[name], t))
                 for name in fns}, args.reps)
            busier = max(cs.THREEFRY_XORS_PER_ELEM[dname],
                         cs.THREEFRY_INT_INSTRS_PER_ELEM[dname] / 2)
            bound = cs.bound(n * 8 + n * t * size, busier * n * t, int_pipe_per_s)
            emit({"times": shape_name, "pass": pass_, "shape": [n, t], "dtype": dname, "ms": ms,
                  "bound_ms": bound[0], "bound_by": bound[1],
                  "share_of_bound": {name: bound[0] / v for name, v in ms.items()},
                  "note": f"median of {args.reps} event pairs around {method}"})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
