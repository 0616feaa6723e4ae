"""GatewayServer -- the networked front-end of the FedNL serving engine (port
of ``repro.gateway.server``).

One asyncio event loop owns everything: the TCP listener, one coroutine per
client connection, and the engine tick cadence.  Device work never runs on
the loop -- each ``tick()`` executes in a worker thread via
``asyncio.to_thread``, on the engine's device -- and socket writes never run
inside the tick: the tick only appends to bounded per-subscription queues,
so a slow (or dead) remote observer can never stall the optimization of
anyone's experiment.  The worker threads change from tick to tick; every
tensor lives on the engine's device, and the engine's lock serializes
``tick``, ``evict``, ``cancel`` and the packing of a RESULT report.

The gateway is pure transport + policy: scheduling policy lives in the
engine's :class:`~repro_torch.serve_fednl.scheduler.FairShareQueue`;
numerics live below that.  Nothing in this module touches an array except
to forward it, so every gateway-served trajectory is the engine's, bit for
bit -- including tenants that were spilled, evicted, or streamed to three
observers along the way.

Backpressure model per STREAM subscription:

    tick thread --append--> deque(maxlen=stream_queue) --drain--> writer coro
                             (drop-oldest, drops counted)     (awaits socket)

The writer coroutine blocks only on its own socket's ``drain()``; when the
observer finally reads, it receives the *newest* records plus a counted-
drops notice in STREAM_END.  An observer that keeps up sees every record.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
from collections import deque

from repro_torch.comm.protocol import Frame, MsgType
from repro_torch.gateway import protocol as gw
from repro_torch.obs import core as _obs
from repro_torch.serve_fednl.engine import FedNLServer, ServeConfig
from repro_torch.serve_fednl.tenant import CANCELLED, EVICTED, FAILED, FINISHED

_TERMINAL = (FINISHED, FAILED, EVICTED, CANCELLED)


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Gateway sizing knobs (engine knobs ride in ``serve``).

    ``stream_queue`` bounds each STREAM subscription's record queue -- the
    drop-oldest window a slow observer gets.  ``idle_sleep_s`` is the tick
    loop's poll interval while no tenant has work.
    """

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral; read the bound port off .port
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    stream_queue: int = 256
    idle_sleep_s: float = 0.002


class _Subscription:
    """One observer of one tenant's record stream (server side)."""

    __slots__ = ("tenant_id", "queue", "drops", "sent", "event", "closed")

    def __init__(self, tenant_id: str, maxlen: int):
        self.tenant_id = tenant_id
        self.queue: deque = deque(maxlen=maxlen)
        self.drops = 0
        self.sent = 0  # records already enqueued (index into tenant.records)
        self.event = asyncio.Event()
        self.closed = False


class GatewayServer:
    """Serve the FedNL engine over TCP (module docstring).

    Lifecycle: construct, ``await start()`` (binds the listener and spawns
    the tick loop), ``await serve_forever()`` or poll, ``await stop()``.
    ``run()`` is the blocking one-call entry point used by
    ``python -m repro_torch.launch.gateway_serve``.  The engine runs on
    ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, config: GatewayConfig | None = None, device=None):
        self.config = config or GatewayConfig()
        self.engine = FedNLServer(self.config.serve, device=device)
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._tick_task: asyncio.Task | None = None
        self._subs: list[_Subscription] = []
        self._done_waiters: dict[str, asyncio.Event] = {}
        self._work = asyncio.Event()
        self._stopping = False
        self._connections = 0
        self._tick_wall: list[float] = []  # per-tick seconds (stats/bench)

    # --- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.config.host, self.config.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._tick_task = asyncio.create_task(self._tick_loop())

    async def serve_forever(self) -> None:
        if self._server is None:
            raise RuntimeError("call start() first")
        async with self._server:
            await self._server.serve_forever()

    async def stop(self, spill: bool = False) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._tick_task is not None:
            self._work.set()
            self._tick_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._tick_task
        for sub in self._subs:
            sub.closed = True
            sub.event.set()
        await asyncio.to_thread(self.engine.shutdown, spill)

    def run(self, ready=None) -> None:
        """Blocking entry point: start, announce, serve until cancelled
        (``request_stop()`` from any thread, or SIGINT)."""

        async def main():
            self._loop = asyncio.get_running_loop()
            self._main_task = asyncio.current_task()
            await self.start()
            if ready is not None:
                ready(self.config.host, self.port)
            try:
                await self.serve_forever()
            except asyncio.CancelledError:
                pass
            finally:
                await self.stop()

        asyncio.run(main())

    def request_stop(self) -> None:
        """Thread-safe shutdown request for a ``run()``-driven gateway."""
        loop = getattr(self, "_loop", None)
        task = getattr(self, "_main_task", None)
        if loop is not None and task is not None and not loop.is_closed():
            loop.call_soon_threadsafe(task.cancel)

    # --- engine tick cadence ----------------------------------------------

    async def _tick_loop(self) -> None:
        """Own the engine cadence: tick in a worker thread while there is
        work, then pump subscriptions/waiters ON the loop thread (single-
        threaded access to the subscription structures -- no locks)."""
        while not self._stopping:
            if self.engine._has_work():
                t0 = _obs.now()
                await asyncio.to_thread(self.engine.tick)
                dt = _obs.now() - t0
                self._tick_wall.append(dt)
                rec = _obs.CURRENT
                if rec.enabled:
                    rec.observe("gateway.tick.s", dt)
                self._pump()
            else:
                self._pump()  # flush terminal states for late subscribers
                self._work.clear()
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(self._work.wait(), self.config.idle_sleep_s)

    def _enqueue_new(self, sub: _Subscription, recs) -> None:
        """Append the records ``sub`` has not seen to its bounded queue
        (drop-oldest, counted)."""
        rec = _obs.CURRENT
        for i in range(sub.sent, len(recs)):
            if len(sub.queue) == sub.queue.maxlen:
                sub.queue.popleft()  # drop-oldest, counted
                sub.drops += 1
                if rec.enabled:
                    rec.add("gateway.stream.dropped")
            sub.queue.append((i, recs[i]))
        sub.sent = len(recs)

    def _pump(self) -> None:
        """Move newly produced records into subscription queues and fire
        completion events.  Appends to bounded deques only -- never a socket
        write, so the engine tick cadence is independent of observers."""
        tenants = self.engine._tenants
        for sub in self._subs:
            t = tenants.get(sub.tenant_id)
            if t is None or sub.closed:
                continue
            recs = t.records
            if sub.sent < len(recs):
                self._enqueue_new(sub, recs)
                sub.event.set()
            if t.status in _TERMINAL:
                sub.closed = True
                sub.event.set()
        for tid, evt in self._done_waiters.items():
            t = tenants.get(tid)
            if t is not None and t.status in _TERMINAL:
                evt.set()

    # --- per-connection RPC loop ------------------------------------------

    async def _handle_connection(self, reader, writer) -> None:
        self._connections += 1
        try:
            while True:
                try:
                    frame = await gw.read_frame_async(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                try:
                    await self._dispatch(frame, writer)
                except (ValueError, TypeError, KeyError) as exc:
                    await gw.write_frame_async(writer, gw.error_frame(exc))
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _dispatch(self, frame: Frame, writer) -> None:
        # RPC latency is a plain labeled observation, not a span: spans nest
        # through a per-thread stack, and concurrent coroutines on the loop
        # thread would interleave their frames
        rec = _obs.CURRENT
        t0 = _obs.now()
        try:
            await self._dispatch_inner(frame, writer)
        finally:
            if rec.enabled:
                rec.observe("gateway.rpc.s", _obs.now() - t0, verb=frame.type.name)

    async def _dispatch_inner(self, frame: Frame, writer) -> None:
        handler = {
            MsgType.SUBMIT: self._rpc_submit,
            MsgType.STATUS: self._rpc_status,
            MsgType.STREAM: self._rpc_stream,
            MsgType.RESULT: self._rpc_result,
            MsgType.EVICT: self._rpc_evict,
            MsgType.CANCEL: self._rpc_cancel,
            MsgType.METRICS: self._rpc_metrics,
        }.get(frame.type)
        if handler is None:
            raise ValueError(f"unexpected frame type {frame.type.name} on a gateway connection")
        await handler(frame, writer)

    async def _rpc_submit(self, frame: Frame, writer) -> None:
        # decode strictly, then validate/enqueue in a worker thread (spec
        # checking may build compressors); errors surface synchronously as
        # GW_ERR naming the field -- never a dead tenant ticks later
        spec, until, tenant_id, options = gw.unpack_submit(frame.payload)
        handle = await asyncio.to_thread(self.engine.submit, spec, until, tenant_id, options)
        self._work.set()
        await gw.write_frame_async(
            writer,
            gw.pack_json(
                MsgType.GW_OK,
                {"tenant_id": handle.id, "priority": handle.priority,
                 "lane": handle._tenant.lane},
            ),
        )

    async def _rpc_status(self, frame: Frame, writer) -> None:
        req = gw.unpack_json(frame.payload)
        tid = req.get("tenant_id")
        if tid is None:
            stats = self.engine.stats()
            stats["connections"] = self._connections
            stats["subscriptions"] = sum(1 for s in self._subs if not s.closed)
            await gw.write_frame_async(writer, gw.pack_json(MsgType.GW_OK, {"stats": stats}))
            return
        t = self.engine._tenants.get(tid)
        if t is None:
            raise KeyError(f"no tenant {tid!r}")
        await gw.write_frame_async(
            writer,
            gw.pack_json(
                MsgType.GW_OK,
                {"tenant_id": tid, "status": t.status, "round": t.round,
                 "records": len(t.records), "priority": t.priority, "lane": t.lane},
            ),
        )

    async def _rpc_stream(self, frame: Frame, writer) -> None:
        """Subscribe this connection to one tenant's records.  The reply is
        GW_OK, then RECORD frames as they are produced, then STREAM_END with
        the drops count.  The connection returns to the RPC loop after."""
        req = gw.unpack_json(frame.payload)
        tid = req.get("tenant_id")
        t = self.engine._tenants.get(tid)
        if t is None:
            raise KeyError(f"no tenant {tid!r}")
        sub = _Subscription(tid, self.config.stream_queue)
        if not req.get("from_start", True):
            sub.sent = len(t.records)  # skip what was produced before subscribing
        self._subs.append(sub)
        try:
            await gw.write_frame_async(writer, gw.pack_json(MsgType.GW_OK, {"tenant_id": tid}))
            self._pump_one(sub)  # catch up on already-produced records
            while True:
                await sub.event.wait()
                sub.event.clear()
                while sub.queue:
                    i, rec = sub.queue.popleft()
                    await gw.write_frame_async(writer, gw.pack_record(tid, i, rec))
                if sub.closed and not sub.queue:
                    break
            t = self.engine._tenants[tid]
            await gw.write_frame_async(
                writer,
                gw.pack_stream_end(tid, sub.drops, t.status,
                                   str(t.error) if t.error is not None else None),
            )
        finally:
            sub.closed = True
            with contextlib.suppress(ValueError):
                self._subs.remove(sub)

    def _pump_one(self, sub: _Subscription) -> None:
        t = self.engine._tenants.get(sub.tenant_id)
        if t is None:
            sub.closed = True
            sub.event.set()
            return
        self._enqueue_new(sub, t.records)
        if t.status in _TERMINAL:
            sub.closed = True
        sub.event.set()

    def _pack_result(self, t) -> bytes:
        with self.engine._lock:
            return gw.pack_report(t.report)

    async def _rpc_result(self, frame: Frame, writer) -> None:
        req = gw.unpack_json(frame.payload)
        tid = req.get("tenant_id")
        t = self.engine._tenants.get(tid)
        if t is None:
            raise KeyError(f"no tenant {tid!r}")
        if t.status not in _TERMINAL:
            evt = self._done_waiters.setdefault(tid, asyncio.Event())
            self._work.set()
            await evt.wait()
            self._done_waiters.pop(tid, None)
            t = self.engine._tenants[tid]
        if t.status == FINISHED:
            payload = await asyncio.to_thread(self._pack_result, t)
            await gw.write_frame_async(writer, Frame(type=MsgType.RESULT, payload=payload))
            return
        detail = {
            FAILED: lambda: f"failed: {t.error}",
            EVICTED: lambda: (
                f"evicted to {t.spill_path} — resume server-side or "
                "fetch the checkpoint out of band"
            ),
            CANCELLED: lambda: "cancelled (state dropped)",
        }[t.status]()
        await gw.write_frame_async(
            writer,
            gw.pack_json(
                MsgType.GW_ERR,
                {"error": f"tenant {tid!r} {detail}", "field": None, "kind": "RuntimeError",
                 "status": t.status},
            ),
        )

    async def _rpc_evict(self, frame: Frame, writer) -> None:
        req = gw.unpack_json(frame.payload)
        tid = req.get("tenant_id")
        path = await asyncio.to_thread(self.engine.evict, tid)
        self._pump()  # release streamers/waiters of the evicted tenant
        await gw.write_frame_async(
            writer, gw.pack_json(MsgType.GW_OK, {"tenant_id": tid, "checkpoint": str(path)})
        )

    async def _rpc_metrics(self, frame: Frame, writer) -> None:
        """METRICS verb: snapshot of the process recorder.

        Reply body: ``{"enabled": bool, "metrics": snapshot}`` -- plus
        ``"prometheus"`` (text exposition) when the request asks
        ``{"format": "prometheus"}``.  Works against a disabled recorder
        (``enabled: false``, empty snapshot) so dashboards can poll
        unconditionally."""
        req = gw.unpack_json(frame.payload)
        rec = _obs.CURRENT
        if not rec.enabled:
            body = {"enabled": False, "metrics": {"enabled": False}}
        else:
            body = {"enabled": True, "metrics": rec.snapshot()}
            if req.get("format") == "prometheus":
                from repro_torch.obs import export

                body["prometheus"] = export.prometheus_text(rec)
        await gw.write_frame_async(writer, gw.pack_json(MsgType.GW_OK, body))

    async def _rpc_cancel(self, frame: Frame, writer) -> None:
        req = gw.unpack_json(frame.payload)
        tid = req.get("tenant_id")
        await asyncio.to_thread(self.engine.cancel, tid)
        self._pump()
        await gw.write_frame_async(writer, gw.pack_json(MsgType.GW_OK, {"tenant_id": tid}))

    # --- introspection ----------------------------------------------------

    def tick_latencies(self) -> list[float]:
        """Wall seconds of every engine tick this gateway has driven."""
        return list(self._tick_wall)


def serve_gateway(config: GatewayConfig | None = None, ready=None, device=None) -> None:
    """Blocking convenience wrapper (``python -m repro_torch.launch.gateway_serve``)."""
    GatewayServer(config, device=device).run(ready=ready)
