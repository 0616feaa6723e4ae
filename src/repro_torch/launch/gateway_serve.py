"""Launch a FedNL gateway of the port: the serving engine behind a TCP socket
(the counterpart of ``scripts/gateway_serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.gateway_serve --port 9970

The same flags as the reference's script, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).  Prints
``LISTENING <host> <port>`` on stdout once the socket is bound (an ephemeral
``--port 0`` is how tests discover the port), then serves until
SIGINT/SIGTERM.  ``--spill-dir`` makes checkpoints survive the process -- a
killed gateway's tenants resume from their FNLS1 spills, in either package.
``--obs`` turns on the recorder that the METRICS verb serves (watch it with
``python -m repro_torch.launch.obs_top``, or the reference's
``scripts/obs_top.py``: the wire surface is the reference's).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9970,
                    help="TCP port (0 = ephemeral, announced on stdout)")
    ap.add_argument("--max-resident", type=int, default=16)
    ap.add_argument("--admit-per-tick", type=int, default=8)
    ap.add_argument("--eviction", default="lru", choices=("lru", "cost"))
    ap.add_argument("--spill-dir", default=None,
                    help="checkpoint dir (default: private tmp, removed at "
                         "shutdown; set one to survive a kill)")
    ap.add_argument("--priorities", default=None,
                    help='JSON class->weight map, e.g. \'{"high": 4, "normal": 2, "low": 1}\'')
    ap.add_argument("--quantum", type=float, default=1.0)
    ap.add_argument("--stream-queue", type=int, default=256,
                    help="bounded per-observer record queue (drop-oldest)")
    ap.add_argument("--obs", action="store_true",
                    help="enable the obs recorder (serve live metrics over the METRICS verb)")
    ap.add_argument("--obs-spans", type=int, default=8192,
                    help="span ring-buffer capacity when --obs is set")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.gateway import GatewayConfig, GatewayServer
    from repro_torch.serve_fednl import DEFAULT_PRIORITIES, ServeConfig

    if args.obs:
        from repro_torch import obs

        obs.enable(span_capacity=args.obs_spans)

    priorities = (
        {k: float(v) for k, v in json.loads(args.priorities).items()}
        if args.priorities
        else dict(DEFAULT_PRIORITIES)
    )
    cfg = GatewayConfig(
        host=args.host,
        port=args.port,
        stream_queue=args.stream_queue,
        serve=ServeConfig(
            max_resident=args.max_resident,
            admit_per_tick=args.admit_per_tick,
            eviction=args.eviction,
            spill_dir=args.spill_dir,
            priorities=priorities,
            quantum=args.quantum,
        ),
    )

    def announce(host, port):
        print(f"LISTENING {host} {port}", flush=True)

    try:
        GatewayServer(cfg, device=args.device).run(ready=announce)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
