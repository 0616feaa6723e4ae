"""GatewayClient -- thin typed client for the gateway RPC (port of
``repro.gateway.client``; it talks to a gateway of either package).

Synchronous by design: a submitting script wants ``submit`` to return a
handle or raise *now* (the gateway validates at submission), and a record
stream is most naturally a generator.  One client = one TCP connection =
one RPC at a time -- a ``stream()`` occupies the connection until the
generator is exhausted or closed, so open a second client for concurrent
streams (connections are cheap; the gateway multiplexes them).

    from repro_torch.gateway import GatewayClient

    with GatewayClient("127.0.0.1", 9970) as gwc:
        h = gwc.submit(spec, until=40, priority="high")
        for rec in gwc.stream(h.id):
            print(rec.round, rec.grad_norm)
        report = gwc.result(h.id)
"""

from __future__ import annotations

import socket
import time

from repro_torch.api.report import RunReport
from repro_torch.comm.protocol import Frame, MsgType, recv_frame, send_frame
from repro_torch.comm.transport import SocketConnection
from repro_torch.gateway import protocol as gw
from repro_torch.gateway.protocol import GatewayError
from repro_torch.obs import core as _obs
from repro_torch.serve_fednl.scheduler import SubmitOptions


class RemoteTenant:
    """Caller-side handle to one gateway-resident tenant (the network
    analogue of :class:`~repro_torch.serve_fednl.tenant.TenantHandle`)."""

    def __init__(self, client: "GatewayClient", tenant_id: str, priority: str, lane: str):
        self._client = client
        self.id = tenant_id
        self.priority = priority
        self.lane = lane

    def status(self) -> dict:
        return self._client.status(self.id)

    def stream(self, from_start: bool = True):
        return self._client.stream(self.id, from_start=from_start)

    def result(self) -> RunReport:
        return self._client.result(self.id)

    def cancel(self) -> None:
        self._client.cancel(self.id)

    def evict(self) -> str:
        return self._client.evict(self.id)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"RemoteTenant({self.id!r}, priority={self.priority!r}, lane={self.lane!r})"


class GatewayClient:
    """One connection to a gateway server.

    Context-manager; all methods raise :class:`GatewayError` when the
    gateway replies GW_ERR (``.field`` names the offending submission
    field when the server could derive it).
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 connect_retry_s: float = 10.0):
        deadline = _obs.monotonic() + connect_retry_s
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=timeout)
                break
            except OSError as exc:  # gateway may still be binding
                if _obs.monotonic() >= deadline:
                    raise ConnectionError(
                        f"gateway {host}:{port} not reachable after "
                        f"{connect_retry_s:.0f}s: {exc}"
                    ) from exc
                time.sleep(0.05)
        self._conn = SocketConnection(sock)
        self.host, self.port = host, port
        self.stream_drops = 0  # drops notice of the most recent stream()
        # cumulative across every stream() on this client: records the
        # gateway's bounded queues dropped before we could read them -- the
        # caller-visible face of the server's gateway.stream.dropped counter
        self.dropped_records = 0

    # --- plumbing ---------------------------------------------------------

    def _rpc(self, frame: Frame) -> Frame:
        send_frame(self._conn, frame)
        reply = recv_frame(self._conn)
        if reply.type == MsgType.GW_ERR:
            err = gw.unpack_json(reply.payload)
            raise GatewayError(err.get("error", "gateway error"), field=err.get("field"),
                               kind=err.get("kind"))
        return reply

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- RPCs -------------------------------------------------------------

    def submit(
        self,
        spec,
        until=None,
        tenant_id: str | None = None,
        priority: str | None = None,
        options: SubmitOptions | None = None,
    ) -> RemoteTenant:
        """Submit one experiment; returns once the gateway has validated
        and enqueued it.  A bad spec/option raises :class:`GatewayError`
        here, synchronously, naming the field.  ``priority`` is shorthand
        for ``options=SubmitOptions(priority=...)``."""
        if priority is not None:
            if options is not None:
                raise ValueError("pass either priority= or options=, not both")
            options = SubmitOptions(priority=priority)
        reply = self._rpc(Frame(
            type=MsgType.SUBMIT,
            payload=gw.pack_submit(spec, until=until, tenant_id=tenant_id, options=options),
        ))
        ok = gw.unpack_json(reply.payload)
        return RemoteTenant(self, ok["tenant_id"], ok["priority"], ok["lane"])

    def status(self, tenant_id: str | None = None) -> dict:
        """One tenant's status dict, or (with no id) the engine stats."""
        reply = self._rpc(gw.pack_json(MsgType.STATUS, {"tenant_id": tenant_id}))
        out = gw.unpack_json(reply.payload)
        return out.get("stats", out)

    def stream(self, tenant_id: str, from_start: bool = True):
        """Yield the tenant's RoundRecords as the gateway produces them
        (``from_start=False`` skips records produced before subscribing).
        The generator ends when the tenant reaches a terminal state; the
        bounded-queue drop count is in ``self.stream_drops`` afterwards.
        The connection is occupied until the generator is exhausted."""
        self._rpc(  # GW_OK subscription ack (or GW_ERR -> raise)
            gw.pack_json(MsgType.STREAM, {"tenant_id": tenant_id, "from_start": from_start})
        )

        def _gen():
            while True:
                frame = recv_frame(self._conn)
                if frame.type == MsgType.RECORD:
                    _tid, _idx, rec = gw.unpack_record(frame.payload)
                    yield rec
                elif frame.type == MsgType.STREAM_END:
                    end = gw.unpack_stream_end(frame.payload)
                    self.stream_drops = int(end["drops"])
                    self.dropped_records += self.stream_drops
                    self.stream_status = end["status"]
                    return
                else:  # pragma: no cover - protocol violation
                    raise GatewayError(f"unexpected {frame.type.name} inside a stream")

        return _gen()

    def result(self, tenant_id: str) -> RunReport:
        """Block until the tenant finishes; returns its RunReport with
        bit-exact records and final iterate.  Raises :class:`GatewayError`
        if it failed / was evicted / was cancelled instead."""
        reply = self._rpc(gw.pack_json(MsgType.RESULT, {"tenant_id": tenant_id}))
        return gw.unpack_report(reply.payload)

    def cancel(self, tenant_id: str) -> None:
        self._rpc(gw.pack_json(MsgType.CANCEL, {"tenant_id": tenant_id}))

    def metrics(self, format: str | None = None) -> dict:
        """Snapshot of the gateway process's obs recorder (the METRICS
        verb).  Returns ``{"enabled": bool, "metrics": snapshot}`` -- with
        ``format="prometheus"`` the reply also carries the text exposition
        under ``"prometheus"``.  Safe against a gateway that never enabled
        observability (``enabled: false``)."""
        body: dict = {}
        if format is not None:
            body["format"] = format
        reply = self._rpc(gw.pack_json(MsgType.METRICS, body))
        return gw.unpack_json(reply.payload)

    def evict(self, tenant_id: str) -> str:
        """Checkpoint + deschedule the tenant; returns the gateway-side
        FNLS1 path (resume it there with ``FedNLServer.resume``)."""
        reply = self._rpc(gw.pack_json(MsgType.EVICT, {"tenant_id": tenant_id}))
        return gw.unpack_json(reply.payload)["checkpoint"]


def stream_records(host: str, port: int, tenant_id: str):
    """One-shot helper: open a dedicated connection and stream one tenant's
    records (use while the submitting client's connection is busy with its
    own RPCs)."""
    with GatewayClient(host, port) as c:
        yield from c.stream(tenant_id)
