"""obs_top: a curses-free live console view of a running gateway of the
port (the counterpart of ``scripts/obs_top.py``).

    PYTHONPATH=src python -m repro_torch.launch.gateway_serve --port 9970 --obs &
    PYTHONPATH=src python -m repro_torch.launch.obs_top --port 9970

Polls the gateway's METRICS verb (and the engine's STATUS stats) every
``--interval`` seconds and redraws a compact dashboard with plain ANSI
escapes: no curses, so it works in any dumb terminal and under ``watch``.
``--once`` prints one frame and exits (scripts, CI); ``--prom`` dumps the
Prometheus text exposition instead of the table.  The same flags as the
reference's script; it reads a gateway of either package (the wire is the
same) and renders through ``repro_torch.obs``.
"""

from __future__ import annotations

import argparse
import sys
import time


def render(status: dict, metrics_reply: dict, width: int = 78) -> str:
    """One frame: the engine's counters, the backlog by class, the batch
    lane, then the recorder's snapshot (or why there is none)."""
    from repro_torch.obs.export import render_snapshot

    lines = ["FedNL gateway — obs_top", "=" * width]
    lines.append(
        "engine: tick {ticks}  tenants {tenants}  finished {finished}  "
        "failed {failed}  queued {queued}  spills {spills}".format(
            **{key: status.get(key, 0)
               for key in ("ticks", "tenants", "finished", "failed", "queued", "spills")}))
    backlog = status.get("backlog", {})
    if backlog:
        lines.append("backlog: " + "  ".join(f"{cls}={n}" for cls, n in sorted(backlog.items())))
    occ = status.get("batch_occupancy")
    lines.append(
        f"batch: launches {status.get('batch_launches', 0)}  "
        f"occupancy {occ if occ is not None else '-'}  "
        f"compiles {status.get('compiles', 0)}  "
        f"connections {status.get('connections', 0)}  "
        f"subscriptions {status.get('subscriptions', 0)}"
    )
    lines.append("-" * width)
    if not metrics_reply.get("enabled", False):
        lines.append("recorder disabled — restart the gateway with --obs to see metrics")
    else:
        lines.append(render_snapshot(metrics_reply["metrics"], width=width))
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--interval", type=float, default=1.0, help="refresh period in seconds")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    ap.add_argument("--prom", action="store_true",
                    help="dump the Prometheus text exposition instead")
    args = ap.parse_args(argv)

    from repro_torch.gateway import GatewayClient

    with GatewayClient(args.host, args.port) as gwc:
        while True:
            if args.prom:
                reply = gwc.metrics(format="prometheus")
                frame = reply.get("prometheus", "# recorder disabled (gateway without --obs)\n")
            else:
                frame = render(gwc.status(), gwc.metrics())
            if args.once or args.prom:
                sys.stdout.write(frame)
                return 0
            # ANSI: home + clear to the end, flicker-free enough without curses
            sys.stdout.write("\x1b[H\x1b[2J" + frame)
            sys.stdout.flush()
            time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
