"""repro_torch.gateway -- networked front-end for the FedNL serving engine
(port of ``repro.gateway``).

The gateway puts :class:`~repro_torch.serve_fednl.FedNLServer` behind a TCP
socket: remote clients SUBMIT serialized ExperimentSpecs, STREAM per-round
records as they are produced, and fetch bit-exact RunReports with RESULT --
while the gateway's asyncio loop owns the engine tick cadence (the ticks run
on worker threads, on the engine's device) and its deficit-round-robin
fair-share scheduler arbitrates between priority classes.  Frames and
payloads are the reference's byte for byte.

Server:  ``python -m repro_torch.launch.gateway_serve`` or::

    from repro_torch.gateway import GatewayConfig, GatewayServer
    GatewayServer(GatewayConfig(port=9970)).run()      # on the card

Client::

    from repro_torch.gateway import GatewayClient
    with GatewayClient("127.0.0.1", 9970) as gwc:
        h = gwc.submit(spec, until=40, priority="high")
        report = gwc.result(h.id)
"""

from repro_torch.gateway.client import GatewayClient, RemoteTenant, stream_records
from repro_torch.gateway.protocol import GatewayError
from repro_torch.gateway.server import GatewayConfig, GatewayServer, serve_gateway

__all__ = [
    "GatewayClient",
    "GatewayConfig",
    "GatewayError",
    "GatewayServer",
    "RemoteTenant",
    "serve_gateway",
    "stream_records",
]
