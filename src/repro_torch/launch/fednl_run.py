"""FedNL launcher CLI of the port (the counterpart of ``repro.launch.fednl_run``).

    PYTHONPATH=src python -m repro_torch.launch.fednl_run \
        --dataset w8a --compressor topk --rounds 1000 --tol 1e-12

The same flags as the reference, plus ``--device`` (default ``cuda``; pass
``cpu`` for the plain PyTorch versions of the kernels).  The flags populate
one ExperimentSpec; algorithms and backends not ported yet are refused.
"""

import argparse

from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
from repro_torch.data import DATASET_SHAPES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="w8a", choices=list(DATASET_SHAPES))
    ap.add_argument("--libsvm", default=None, help="path to a LIBSVM file")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--per-client", type=int, default=None)
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--k-multiplier", type=float, default=8.0)
    ap.add_argument("--option", default="B", choices=["A", "B"])
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument("--line-search", action="store_true")
    ap.add_argument("--backend", default="local")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.libsvm and (args.clients is None or args.per_client is None):
        raise SystemExit("--libsvm requires --clients and --per-client")
    spec = ExperimentSpec(
        lam=args.lam,
        data=DataSpec(
            dataset=args.dataset,
            libsvm=args.libsvm,
            clients=args.clients,
            per_client=args.per_client,
            seed=args.seed,
        ),
        algorithm="fednl-ls" if args.line_search else "fednl",
        compressor=CompressorSpec(args.compressor, args.k_multiplier),
        option=args.option,
        mu=args.lam,
        backend=args.backend,
        rounds=args.rounds,
        tol=args.tol,
        seed=args.seed,
    )
    z = spec.data.build()
    n, n_i, d = z.shape
    print(f"problem: n={n} clients, n_i={n_i}, d={d}")
    rep = solve(spec, z=z, device=args.device)
    print(rep.summary())


if __name__ == "__main__":
    main()
