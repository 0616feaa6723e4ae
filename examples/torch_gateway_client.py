"""End-to-end gateway demo on the PyTorch port: a fleet of prioritized remote
submissions; the port of ``examples/gateway_client.py``.

Starts a gateway in a subprocess (as a deployment would run
``python -m repro_torch.launch.gateway_serve``), then from this process:
submits experiments across the three priority classes, watches one of them
round by round over a second connection, fetches every result, and checks
one trajectory against a local solo run on the same device (the DESIGN.md
§14 contract): bit for bit on the CPU; on the card, where the engine's
batched lane factors its group's Hessians in one batched Cholesky, the
same ``sent_bits`` and grad norms within 1e-8 relative where they are
>= 1e-10, the served tenant's bound.

    PYTHONPATH=src python examples/torch_gateway_client.py [--device cpu]
"""

import argparse
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
    from repro_torch.device import resolve_device
    from repro_torch.gateway import GatewayClient, GatewayError, stream_records

    dev = resolve_device(args.device)
    src = str(REPO / "src")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway_serve", "--port", "0",
         "--max-resident", "4", "--device", dev.type],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [src, *filter(None, [os.environ.get("PYTHONPATH")])])},
    )
    try:
        _, host, port = proc.stdout.readline().split()  # "LISTENING h p"
        print(f"gateway up on {host}:{port} ({dev.type})")

        def spec_of(seed, comp, rounds):
            return ExperimentSpec(
                data=DataSpec(shape=(12, 4, 20), seed=1),
                compressor=CompressorSpec(comp, 8.0),
                rounds=rounds, seed=seed,
            )

        with GatewayClient(host, int(port), connect_retry_s=30) as gwc:
            # a bad submission fails HERE, naming the field, not ticks later
            try:
                gwc.submit(spec_of(0, "topk", 4), priority="platinum")
            except GatewayError as e:
                print(f"rejected synchronously ({e.field}): {e}")

            fleet = [
                ("high", spec_of(0, "topk", 12)),
                ("normal", spec_of(1, "randk", 10)),
                ("normal", spec_of(2, "randseqk", 10)),
                ("low", spec_of(3, "identity", 8)),
            ]
            handles = [(gwc.submit(s, priority=p), s) for p, s in fleet]

            # live-stream the low-priority tenant on its own connection
            watch = handles[-1][0]
            for rec in stream_records(host, int(port), watch.id):
                print(f"  [{watch.id} {watch.priority}] round {rec.round} "
                      f"||grad||={rec.grad_norm:.3e}")

            for h, spec in handles:
                report = h.result()
                print(f"{h.id} ({h.priority}): {report.rounds} rounds, "
                      f"final ||grad||={report.final_grad_norm:.3e}")

            # the §14 bar: remote result == local solve
            h0, spec0 = handles[0]
            local = solve(spec0, device=dev)
            remote = h0.result()
            same = all(
                float(a.grad_norm).hex() == float(b.grad_norm).hex()
                for a, b in zip(remote.records, local.records)
            ) and (remote.x == local.x).all()
            want = np.asarray(local.grad_norms)
            keep = want >= 1e-10
            close = remote.rounds == local.rounds and bool(
                np.all(remote.sent_bits == local.sent_bits)) and bool(np.all(
                    np.abs(np.asarray(remote.grad_norms)[keep] - want[keep]) <= 1e-8 * want[keep]))
            print(f"bit-identical to local solve: {same}")
            if dev.type == "cuda":
                print(f"within the served tenant's bounds of local solve: {close}")
            stats = gwc.status()
            print(f"engine stats: ticks={stats['ticks']} "
                  f"admissions_by_class={stats['admissions_by_class']}")
            return 0 if (same if dev.type == "cpu" else close) else 1
    finally:
        proc.kill()
        proc.wait(10)


if __name__ == "__main__":
    sys.exit(main())
