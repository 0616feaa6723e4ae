"""Run every example of the PyTorch port (examples/torch_*.py) and the
obs_top viewer, each in its own process, on the card (or ``--device
cpu``): each one's exit code, seconds and last output lines, then one JSON
line with them all.  Exits 1 if any failed.

    PYTHONPATH=src python scripts/run_torch_examples.py [--device cpu] [--only quickstart,serve_lm]

The examples run with their defaults (the full w8a pipeline of
e2e_fednl_w8a with ``--fast``; ``--rounds`` of train_lm cut to 30 steps);
obs_top reads a gateway started with ``--obs`` after one tenant ran.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {  # name: the example's arguments besides --device
    "quickstart": [],
    "e2e_fednl_w8a": ["--fast", "--out", "results/e2e_fednl_w8a_torch"],
    "sweep_grid": [],
    "distributed_fednl": [],
    "multinode_tcp_fednl": [],
    "multinode_pp_fednl": [],
    "tree_async_fednl": [],
    "gateway_client": [],
    "serve_lm": [],
    "train_lm": ["--steps", "30"],
    "fednl_probe": [],
}


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])])}


def run_example(name: str, device: list[str], timeout: float) -> dict:
    cmd = [sys.executable, f"examples/torch_{name}.py", *EXAMPLES[name], *device]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=timeout)
    return {"name": name, "code": done.returncode, "seconds": time.perf_counter() - t0,
            "tail": done.stdout.strip().splitlines()[-4:],
            "stderr_tail": done.stderr.strip().splitlines()[-3:] if done.returncode else []}


def run_obs_top(device: list[str], timeout: float) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import DataSpec, ExperimentSpec
    from repro_torch.gateway import GatewayClient

    t0 = time.perf_counter()
    gateway = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway_serve", "--port", "0", "--obs",
         *(device or ["--device", "cuda"])], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        text=True)
    try:
        _, host, port = gateway.stdout.readline().split()
        with GatewayClient(host, int(port), connect_retry_s=60) as gwc:
            gwc.submit(ExperimentSpec(data=DataSpec(dataset="tiny"), rounds=5)).result()
        done = subprocess.run([sys.executable, "-m", "repro_torch.launch.obs_top", "--host", host,
                               "--port", port, "--once"], cwd=ROOT, env=_env(),
                              capture_output=True, text=True, timeout=timeout)
    finally:
        gateway.kill()
        gateway.wait(30)
    return {"name": "launch.obs_top", "code": done.returncode,
            "seconds": time.perf_counter() - t0, "tail": done.stdout.strip().splitlines()[:4],
            "stderr_tail": done.stderr.strip().splitlines()[-3:] if done.returncode else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--only", default=None, help="comma-separated example names")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds an example")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    names = args.only.split(",") if args.only else [*EXAMPLES, "obs_top"]
    results = []
    for name in names:
        try:
            out = run_obs_top(device, args.timeout) if name == "obs_top" else \
                run_example(name, device, args.timeout)
        except subprocess.TimeoutExpired:
            out = {"name": name, "code": "timeout", "seconds": args.timeout, "tail": []}
        results.append(out)
        print(f"{out['name']}: exit {out['code']} in {out['seconds']:.1f}s", flush=True)
        for line in out["tail"] + out.get("stderr_tail", []):
            print(f"    {line}", flush=True)
    print(json.dumps({"examples": results, "device": args.device or "cuda"}), flush=True)
    return 0 if all(r["code"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
