"""Quickstart on the PyTorch port: L2-regularized logistic regression with
FedNL in seconds; the port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--compressor topk] [--device cpu]

One declarative ExperimentSpec describes the whole run.  The simple path is
one call, ``solve(spec)``, and changing only ``backend=`` ("local" |
"sharded" | "star-loopback" | "star-tcp") runs the same experiment on
another backend.  The second half is the Session form of the same run:
rounds streamed through an observer, an early stop on a custom criterion, a
checkpoint mid-run, and a resume that is bit for bit the uninterrupted run.
Everything runs on the card unless ``--device cpu`` is given.
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.api import (
    CompressorSpec,
    DataSpec,
    ExperimentSpec,
    StopPolicy,
    open_session,
    solve,
)
from repro_torch.core import newton_baseline
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--compressor", default="topk",
                    choices=["topk", "randk", "randseqk", "toplek", "natural", "identity"])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--backend", default="local")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a small federated problem: 8 clients x 40 samples, d = 24
    spec = ExperimentSpec(
        data=DataSpec(dataset="tiny", seed=0),
        compressor=CompressorSpec(args.compressor, k_multiplier=8.0),
        backend=args.backend,
        rounds=args.rounds,
        tol=1e-14,
    )
    d, n, n_i = spec.data.dims()
    print(f"problem: {n} clients x {n_i} samples, d={d}, on {dev}")

    # build the problem once, shared with the centralized baseline below
    # (star-tcp clients rebuild their shards from the seed instead)
    z = spec.data.build()
    tcp = args.backend == "star-tcp"

    # --- the simple path: one declarative spec, one call -------------------
    rep = solve(spec, device=dev) if tcp else solve(spec, z=z, device=dev)
    print(f"FedNL(B)/{args.compressor}@{rep.backend}: {rep.rounds} rounds, "
          f"||grad|| = {rep.grad_norms[-1]:.2e}, "
          f"solve {rep.wall_time_s:.2f}s (init {rep.init_time_s:.2f}s)")
    for r in range(0, rep.rounds, max(1, rep.rounds // 10)):
        print(f"  round {r:3d}  ||grad|| = {rep.records[r].grad_norm:.3e}")

    nb = newton_baseline(z, 1e-3, device=dev)
    err = float(np.linalg.norm(np.asarray(rep.x) - nb.x))
    print(f"distance to centralized Newton solution: {err:.2e}")

    # --- the incremental path: the SAME run, round by round ----------------
    # An observer streams records as they are produced; run() takes a custom
    # early-stop criterion that solve() has no field for (here: stop once the
    # gradient dropped 6 orders).
    session = open_session(spec, device=dev) if tcp else open_session(spec, z=z, device=dev)
    session.on_round(
        lambda rec: rec.round % 10 == 0
        and print(f"  [observer] round {rec.round:3d}  ||grad|| = {rec.grad_norm:.3e}")
    )
    session.step(5)  # drive a few rounds by hand...
    ckpt = Path(tempfile.mkdtemp()) / "quickstart.fnlsess"
    session.save(ckpt)  # ...checkpoint mid-run...
    early = session.run(  # ...then finish under a custom stop criterion
        until=StopPolicy(predicate=lambda rec: rec.grad_norm < 1e-6)
    )
    session.close()
    print(f"session: stopped early at round {early.rounds} "
          f"(||grad|| = {early.grad_norms[-1]:.2e}), checkpoint at round 5")

    # resume the checkpoint under the original budget: bit for bit the
    # uninterrupted solve() above
    with open_session(spec, restore=ckpt, device=dev) as resumed:
        rep2 = resumed.run()
    same = [g.hex() for g in rep2.grad_norms] == [g.hex() for g in rep.grad_norms]
    print(f"resumed from round 5 -> {rep2.rounds} rounds; bit-identical to solve(): {same}")
    assert same, "save -> resume must reproduce the uninterrupted trajectory"
    return rep


if __name__ == "__main__":
    main()
