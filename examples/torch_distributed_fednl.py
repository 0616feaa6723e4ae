"""Multi-device FedNL on the PyTorch port: the sharded backend over
torch.distributed (NCCL between cards; gloo ranks on the CPU); the port of
``examples/distributed_fednl.py``.

One ExperimentSpec with ``backend="sharded"``; the sweep varies only the
``aggregate`` field between the two collective strategies:
  dense_psum        faithful dense collective (paper semantics)
  sparse_allgather  compressed collective (beyond-paper, DESIGN.md §7)

    PYTHONPATH=src python examples/torch_distributed_fednl.py [--device cpu] [--devices 8]

``--devices``: the ranks; by default every card, or on the CPU 8 gloo
ranks (the reference's 8 devices).  The 48 clients split evenly over 1, 2,
4, 6, 8 or 12 ranks.
"""

import argparse

import torch

from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
from repro_torch.device import resolve_device
from repro_torch.linalg import triu_size


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: every card; 8 on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    devices = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 8)
    print(f"devices: {devices} ({dev.type})")
    d, n, n_i = 121, 48, 96  # 48 clients sharded over the ranks
    t = triu_size(d)
    base = ExperimentSpec(
        data=DataSpec(shape=(d, n, n_i), seed=0),
        compressor=CompressorSpec("topk", k_multiplier=8.0),
        backend="sharded",
        devices=devices,
        rounds=40,
        tol=1e-14,
    )
    k = base.fednl_config().k_for(d)

    reports = {}
    for agg in ["dense_psum", "sparse_allgather"]:
        rep = reports[agg] = solve(base.replace(aggregate=agg), device=dev)
        payload = k * 12 if agg == "sparse_allgather" else t * 8
        print(f"{agg:17s}: {rep.rounds} rounds, ||grad|| = {rep.grad_norms[-1]:.2e}, "
              f"collective payload/client/round = {payload / 1e3:.1f} kB "
              f"({'idx+val pairs' if 'sparse' in agg else 'dense packed triu'})")
    return reports


if __name__ == "__main__":
    main()
