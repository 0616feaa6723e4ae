"""Transports of the FedNL star (port of ``repro.comm.transport``).

Two implementations behind one byte-stream ``Connection`` interface, which is
duck-typed: a master of one package drives clients of the other over either.

  * loopback -- in-process buffered pipes.  The master and its clients run in
    one thread on a synchronous schedule (broadcast, drive the clients, read
    the replies), so every byte still crosses encode -> frame -> decode.
  * TCP -- real sockets.  ``TCPMaster`` binds, accepts ``n_clients``
    connections and identifies each peer by its HELLO frame;
    ``connect_to_master`` retries while the master's socket comes up.
    TCP_NODELAY is set on every socket: rounds are latency-bound exchanges of
    small frames.

``FaultSpec`` / ``FaultInjector`` are FedNL-PP's dropout and straggler model;
the injector draws from numpy's ``default_rng((seed, client_id))``, as the
reference's does, so the two packages drop the same clients.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Callable

import numpy as np

from repro_torch.comm import protocol
from repro_torch.obs import core as _obs


class Connection:
    """A reliable, ordered byte stream."""

    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def recv_exact(self, n: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# fault injection (FedNL-PP dropout / straggler model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-client fault model for partial-participation runs.

    ``drop_prob``: probability a chosen client drops the round (it answers
    the SELECT with a DROP frame).  ``straggler_prob`` /
    ``straggler_delay_s``: probability and duration of a stall before the
    reply.  ``seed`` seeds the clients' fault draws.
    """

    drop_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_delay_s: float = 0.0
    seed: int = 0

    @property
    def active(self) -> bool:
        return self.drop_prob > 0.0 or self.straggler_prob > 0.0


class FaultInjector:
    """Deterministic per-client fault source (one per PP client)."""

    def __init__(self, spec: FaultSpec, client_id: int):
        self.spec = spec
        self._rng = np.random.default_rng((spec.seed, client_id))

    def should_drop(self) -> bool:
        return bool(self._rng.random() < self.spec.drop_prob)

    def maybe_stall(self) -> float:
        """Sleep the configured straggler delay; returns seconds stalled."""
        if self._rng.random() < self.spec.straggler_prob:
            time.sleep(self.spec.straggler_delay_s)
            return self.spec.straggler_delay_s
        return 0.0


# ---------------------------------------------------------------------------
# loopback
# ---------------------------------------------------------------------------


class LoopbackConnection(Connection):
    def __init__(self):
        self._peer: LoopbackConnection | None = None
        self._buf = bytearray()
        self.bytes_sent = 0

    def send(self, data: bytes) -> None:
        if self._peer is None:
            raise RuntimeError("unpaired loopback connection")
        self._peer._buf.extend(data)
        self.bytes_sent += len(data)

    def recv_exact(self, n: int) -> bytes:
        if len(self._buf) < n:
            raise RuntimeError(
                f"loopback underrun: want {n} bytes, have {len(self._buf)} "
                "(master/client schedule out of sync)"
            )
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def pending(self) -> int:
        """Buffered bytes awaiting recv (a PP drive serves only the clients
        that have frames: those SELECTed this round)."""
        return len(self._buf)


def loopback_pair() -> tuple[LoopbackConnection, LoopbackConnection]:
    a, b = LoopbackConnection(), LoopbackConnection()
    a._peer, b._peer = b, a
    return a, b


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------


class SocketConnection(Connection):
    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self.bytes_sent = 0

    def send(self, data: bytes) -> None:
        self._sock.sendall(data)
        self.bytes_sent += len(data)

    def recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self._sock.recv(min(n - got, 1 << 20))
            if not chunk:
                raise ConnectionError(f"peer closed after {got}/{n} bytes")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TCPMaster:
    """The hub of the star: binds, then accepts and identifies n clients."""

    def __init__(self, n_clients: int, host: str = "127.0.0.1", port: int = 0):
        self.n_clients = n_clients
        self._listener = socket.create_server((host, port), backlog=n_clients)
        self.host, self.port = self._listener.getsockname()[:2]

    def accept_clients(
        self, timeout: float = 120.0, alive: Callable[[], bool] | None = None
    ) -> dict[int, SocketConnection]:
        """Accept exactly n_clients connections within ``timeout`` seconds; map
        them by HELLO client id.  ``alive`` (checked every second while
        waiting) returning False raises at once: a client process died
        before it connected."""
        deadline = _obs.monotonic() + timeout
        self._listener.settimeout(1.0)
        conns: dict[int, SocketConnection] = {}
        try:
            while len(conns) < self.n_clients:
                try:
                    sock, _addr = self._listener.accept()
                except TimeoutError:
                    if alive is not None and not alive():
                        raise ConnectionError("a client process exited before it connected")
                    if _obs.monotonic() >= deadline:
                        raise
                    continue
                sock.settimeout(None)
                conn = SocketConnection(sock)
                hello = protocol.recv_frame(conn)
                if hello.type != protocol.MsgType.HELLO:
                    conn.close()
                    raise ConnectionError(f"expected HELLO, got {hello.type}")
                if hello.client in conns:
                    conn.close()
                    raise ConnectionError(f"duplicate client id {hello.client}")
                conns[hello.client] = conn
        except BaseException:
            for conn in conns.values():
                conn.close()
            raise
        return conns

    def close(self) -> None:
        self._listener.close()


def connect_to_master(
    host: str, port: int, client_id: int, timeout: float = 120.0
) -> SocketConnection:
    """Dial the master, retrying until it is listening; send HELLO."""
    deadline = _obs.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            break
        except OSError:
            if _obs.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    conn = SocketConnection(sock)
    protocol.send_frame(conn, protocol.Frame(type=protocol.MsgType.HELLO, client=client_id))
    return conn
