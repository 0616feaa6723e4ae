"""End-to-end driver on the PyTorch port at the paper's full single-node
scale (Table 1 setup); the port of ``examples/e2e_fednl_w8a.py``.

  W8A-shaped problem, d = 301 features (300 + intercept), n = 142 clients,
  n_i = 348 samples/client, lambda = 1e-3, FedNL(B), alpha = 1 (scaled
  compressors), r <= 1000 rounds with early stop at ||grad|| < 1e-15.

Pipeline: generate -> write LIBSVM to disk -> parse -> shuffle/partition ->
train on the card -> report per-compressor wall time and uplink -> save the
model.

    PYTHONPATH=src python examples/torch_e2e_fednl_w8a.py [--rounds 1000] [--fast] [--device cpu]

``--dataset`` runs the same pipeline at another of the generator's shapes
(a9a, phishing, or tiny for a quick check).
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
from repro_torch.data import (
    DATASET_SHAPES,
    add_intercept,
    make_synthetic_logreg,
    parse_libsvm,
    partition_clients,
    write_libsvm,
)
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import save_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--fast", action="store_true",
                    help="stop at tol instead of running all rounds")
    ap.add_argument("--out", default="results/e2e_fednl_w8a")
    ap.add_argument("--dataset", default="w8a", choices=sorted(DATASET_SHAPES))
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    d, n, n_i = DATASET_SHAPES[args.dataset]
    t0 = time.perf_counter()
    x, y = make_synthetic_logreg(args.dataset, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{args.dataset}.libsvm")
        write_libsvm(path, x, y)
        x2, y2 = parse_libsvm(path, n_features=d - 1)
    z = partition_clients(add_intercept(x2), y2, n, n_i, seed=0)
    print(f"data pipeline: {time.perf_counter() - t0:.2f}s "
          f"(write+parse+partition, {z.shape}); solving on {dev}")

    os.makedirs(args.out, exist_ok=True)
    # one declarative spec; the sweep varies only the compressor field
    # (z from the LIBSVM round trip above goes straight to solve)
    base = ExperimentSpec(
        data=DataSpec(dataset=args.dataset, seed=0),
        rounds=args.rounds,
        tol=1e-15 if args.fast else 0.0,
    )
    summary = []
    for comp in ["randseqk", "topk", "toplek", "randk", "natural", "identity"]:
        rep = solve(base.replace(compressor=CompressorSpec(comp, 8.0)), z=z, device=dev)
        mb = float(np.sum(rep.sent_bits)) / 8e6
        line = (f"FedNL(B)/{comp:9s} rounds={rep.rounds:4d} "
                f"||grad||={rep.grad_norms[-1]:.2e} "
                f"solve={rep.wall_time_s:8.2f}s init={rep.init_time_s:5.2f}s "
                f"uplink={mb:9.1f} MB")
        print(line)
        summary.append(line)
        save_checkpoint(os.path.join(args.out, f"model_{comp}.npz"), {"x": np.asarray(rep.x)})
    with open(os.path.join(args.out, "summary.txt"), "w") as fh:
        fh.write("\n".join(summary) + "\n")
    print(f"saved models + summary to {args.out}/")
    return summary


if __name__ == "__main__":
    main()
