"""A whole paper table in one call on the PyTorch port: ExperimentSpec.grid ->
solve_many; the port of ``examples/sweep_grid.py``.

    PYTHONPATH=src python examples/torch_sweep_grid.py [--device cpu]

Builds the compressor x seed grid of single-node FedNL runs (the shape of
the paper's Table 1 sweep), runs it through the batched sweep engine (the
shape-compatible specs of the grid run as one group, each kernel launched
once a round for the whole group), and aggregates the per-round records
with the SweepReport helpers.
"""

import argparse

import numpy as np

from repro_torch.api import DataSpec, ExperimentSpec, solve_many
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = ExperimentSpec(
        data=DataSpec(dataset="tiny", seed=1),
        algorithm="fednl",
        rounds=12,
    )
    sweep = base.grid(
        compressor=["topk", "randk", "randseqk", "toplek", "natural"],
        seed=[0, 1, 2],
    )
    print(f"grid: {sweep.n_specs} specs "
          f"({' x '.join(f'{name}[{len(vals)}]' for name, vals in sweep.axes)}) on {dev}")

    report = solve_many(sweep, device=dev)
    print(report.summary())
    for line in report.log:
        print("  engine:", line)

    # per-compressor convergence, averaged over the seed axis
    print(f"\n{'compressor':<10s} {'final ||grad||':>16s} {'MB uplinked':>12s}")
    for (comp,), runs in report.group_by("compressor.name").items():
        gn = np.mean([r.grad_norms[-1] for r in runs])
        mb = np.mean([np.sum(r.sent_bits) for r in runs]) / 8e6
        print(f"{comp:<10s} {gn:>16.3e} {mb:>12.3f}")

    # the full per-round bit/accuracy tables, one row per spec
    grad_table = report.round_table("grad_norm")
    bits_table = report.round_table("sent_bits")
    print(f"\nround tables: grad {grad_table.shape}, bits {bits_table.shape}; "
          f"median round-5 grad norm {np.median(grad_table[:, 5]):.3e}")
    return report


if __name__ == "__main__":
    main()
