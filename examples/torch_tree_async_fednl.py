"""Hierarchical and elastic FedNL on the PyTorch port: the topology layer
(``repro_torch.comm.topology``) end to end; the port of
``examples/tree_async_fednl.py``.

Three runs of the same problem over the loopback wire backend:

  1. a depth-2 tree of stars (16 clients behind 4 aggregators) that
     reproduces the flat star bit for bit while the root reads 4 uplinks a
     round instead of 16;
  2. bounded-staleness async aggregation: the barrier replaced by the
     contract "an update computed against x^r lands by commit r+s", the
     staleness/accuracy trade printed per bound;
  3. an elastic cohort: one client joins mid-run (a late INIT at the current
     iterate, its T*64-bit state uplink accounted exactly) and one leaves
     (retired from the Hessian invariant exactly, through the master's
     per-client mirrors).

    PYTHONPATH=src python examples/torch_tree_async_fednl.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.api import (
    DataSpec,
    ExperimentSpec,
    MembershipEvent,
    MembershipSpec,
    TopologySpec,
    solve,
)
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = ExperimentSpec(
        data=DataSpec(shape=(16, 16, 12), seed=0),  # d=16, 16 clients
        backend="star-loopback",
        rounds=12,
        seed=0,
    )

    # --- 1. tree of stars: 4 aggregators x 4 clients, bit parity ----------
    star = solve(base, device=dev)
    tree = solve(base.replace(topology=TopologySpec(kind="tree", fanout=4, depth=2)), device=dev)
    same_tree = bool(np.array_equal(star.x, tree.x))
    print(f"tree of stars (4 aggregators x 4 clients, combine='exact') on {dev}:")
    print(f"  flat star : ||grad|| = {star.grad_norms[-1]:.2e}")
    print(f"  tree      : ||grad|| = {tree.grad_norms[-1]:.2e}  bit-identical to star: {same_tree}")

    # --- 2. async: bounded staleness instead of the barrier ---------------
    print("\nasync aggregation (max_delay=3, spec'd arrival schedule):")
    for s in (0, 1, 3):
        rep = solve(base.replace(topology=TopologySpec(
            mode="async", staleness=s, max_delay=3, schedule_seed=7)), device=dev)
        note = ("== sync barrier bit for bit" if np.array_equal(rep.x, star.x)
                else "stale gradients, still converging")
        print(f"  staleness={s}: ||grad|| = {rep.grad_norms[-1]:.2e}  ({note})")

    # --- 3. elastic membership: join + leave as spec'd events -------------
    mem = MembershipSpec(
        events=(
            MembershipEvent(round=3, action="join", client=15),
            MembershipEvent(round=6, action="leave", client=0),
        )
    )
    rep = solve(base.replace(membership=mem), device=dev)
    sizes = {r.round: len(r.participants) for r in rep.records}
    print("\nelastic membership (client 15 joins @3, client 0 leaves @6):")
    print(f"  cohort sizes: r0={sizes[0]} r3={sizes[3]} r6={sizes[6]}")
    print(f"  ||grad|| = {rep.grad_norms[-1]:.2e} "
          f"(checkpoint/resume replays the same cohort history)")
    return {"tree_bit_identical": same_tree, "cohort_sizes": sizes}


if __name__ == "__main__":
    main()
