"""Real multi-node FedNL-PP on the PyTorch port: partial participation over
TCP on localhost; the port of ``examples/multinode_pp_fednl.py``.

Algorithm 3 in miniature, through the declarative API: the master samples
tau of the client processes each round; only those get a SELECT frame and
uplink the compressed triple ``encode(S_i) || dl_i || dg_i`` through the
Section-7 wire codecs.  The fault-free tau = n spec is solved again with
``backend="local"`` (the only field that changes) and checked: the same
clients and bits, the models within 1e-8 (the master adds the uplinks in
another order than the simulation, so they may differ in the last bits);
a second sweep injects 20% dropout and shows that both Algorithm-3
fallback policies still drive the gradient below 1e-9.

    PYTHONPATH=src python examples/torch_multinode_pp_fednl.py [--device cpu]

``--clients`` shrinks the run (8 client processes by default).
"""

import argparse

import numpy as np

from repro_torch.api import DataSpec, ExperimentSpec, FaultSpec, solve
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--clients", type=int, default=8, help="client processes (at least 3)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shape = (24, args.clients, 40)  # d, n_clients, n_i: one process a client
    n = shape[1]
    base = ExperimentSpec(
        algorithm="fednl-pp",
        data=DataSpec(shape=shape, seed=0),
        backend="star-tcp",
        seed=0,
    )

    # --- fault-free: tau = n reproduces the simulation ----------------------
    spec = base.replace(tau=n, rounds=10)
    rep = solve(spec, device=dev)
    ref = solve(spec.replace(backend="local"), device=dev)
    dx = float(np.max(np.abs(rep.x_hist - ref.x_hist)))
    print(f"tau={n} (full): {rep.rounds} rounds over TCP, "
          f"uplink={rep.extras['measured_frame_bytes'].sum() / 1e3:.1f} kB framed, "
          f"max|x_tcp - x_sim|={dx:.1e}")
    assert rep.participants == ref.participants and (rep.sent_bits == ref.sent_bits).all()
    assert dx <= 1e-8 * float(np.max(np.abs(ref.x_hist))), \
        "fault-free PP run must reproduce the simulation"
    assert (rep.extras["measured_payload_bits"] == rep.sent_bits_payload).all()

    # --- partial participation with injected dropout -----------------------
    fault = FaultSpec(drop_prob=0.2, seed=7)
    finals = {}
    for policy in ["partial", "resample"]:
        rep = solve(base.replace(tau=3, rounds=60, fault=fault, on_dropout=policy), device=dev)
        drops = sum(len(d) for d in rep.dropped)
        parts = sum(len(p) for p in rep.participants)
        finals[policy] = rep.final_grad_norm
        print(f"tau=3 drop=20% on_dropout={policy}: contributions={parts} "
              f"drops={drops} ||grad(x_final)||={rep.final_grad_norm:.2e}")
        assert rep.final_grad_norm < 1e-9, "dropout-injected PP run must still converge"
    return finals


if __name__ == "__main__":
    main()
