"""Real multi-node FedNL on the PyTorch port: a master and client OS
processes over TCP on localhost; the port of
``examples/multinode_tcp_fednl.py``.

The paper's Section-7 deployment in miniature, through the declarative API:
one ExperimentSpec per compressor with ``backend="star-tcp"`` (a master and
one OS process per client, the Section-7 wire codecs), and the same spec
solved again with ``backend="local"``, the only field that changes, to
check that the TCP run reproduces the single-node simulation.

The second half drives the same deployment through the Session API: a live
multi-node run stepped by hand, the master checkpointed mid-run, the whole
process tree torn down, and a resume from the checkpoint: the fresh client
processes rebuild their state from the spec and the replayed PRNG spine (no
client state touches disk), bit for bit an uninterrupted run.

    PYTHONPATH=src python examples/torch_multinode_tcp_fednl.py [--device cpu]

``--clients`` and ``--compressors`` shrink the run (8 client processes and
topk, randseqk, natural by default).
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, open_session, solve
from repro_torch.comm.cost import DEFAULT_COST
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--clients", type=int, default=8, help="client processes")
    ap.add_argument("--compressors", default="topk,randseqk,natural")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shape = (24, args.clients, 40)  # d, n_clients, n_i: one process a client
    base = ExperimentSpec(
        data=DataSpec(shape=shape, seed=0),
        backend="star-tcp",
        rounds=12,
        tol=1e-14,
        seed=0,
    )
    for comp in args.compressors.split(","):
        spec = base.replace(compressor=CompressorSpec(comp))
        rep = solve(spec, device=dev)
        ref = solve(spec.replace(backend="local"), device=dev)
        r = min(rep.rounds, ref.rounds)
        dx = float(np.max(np.abs(rep.x - ref.x)))
        comm_ms = DEFAULT_COST.round_s(
            float(rep.extras["measured_payload_bits"][-1]), shape[0] * 64, shape[1]
        ) * 1e3
        print(f"{comp:9s}: {rep.rounds} rounds over TCP, ||grad||={rep.grad_norms[-1]:.2e}, "
              f"uplink={rep.extras['measured_frame_bytes'].sum() / 1e3:.1f} kB framed, "
              f"cost-model {comm_ms:.2f} ms/round, max|x_tcp - x_sim|={dx:.1e}")
        assert dx <= 1e-8, "TCP run must reproduce the simulation trajectory"
        assert (rep.extras["measured_payload_bits"][:r] == rep.sent_bits_payload[:r]).all()

    # --- pause and resume the multi-node run -------------------------------
    spec = base.replace(compressor=CompressorSpec("topk"))
    uninterrupted = solve(spec, device=dev)
    ckpt = Path(tempfile.mkdtemp()) / "tcp_master.fnlsess"
    with open_session(spec, device=dev) as session:  # spawns the client processes
        session.step(2)
        session.step(3)  # step(2) + step(3): composable round driving
        session.save(ckpt)  # only the master's state
    # leaving the `with` stopped the master and tore down every client process
    print(f"checkpointed master at round 5 -> {ckpt.name} "
          f"({ckpt.stat().st_size} bytes), cluster torn down")

    with open_session(spec, restore=ckpt, device=dev) as session:  # a fresh cluster
        resumed = session.run()
    same = [g.hex() for g in resumed.grad_norms] == [g.hex() for g in uninterrupted.grad_norms]
    print(f"resumed round 5 -> {resumed.rounds}; clients rebuilt by PRNG-spine replay; "
          f"bit-identical to uninterrupted run: {same}")
    assert same, "kill -> resume must reproduce the uninterrupted trajectory"
    return same


if __name__ == "__main__":
    main()
