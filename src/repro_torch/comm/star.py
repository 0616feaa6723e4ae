"""Star-topology FedNL: a master event loop and client workers (port of
``repro.comm.star``).

The paper's Section-7 multi-node setting: n clients connect to one master;
every round the master broadcasts the iterate x, each client runs Algorithm
1's client body on its own shard and uplinks ``grad_i || l_i || f_i ||
encode(S_i)`` through a wire codec; the master decodes, averages and takes
the Newton-type step.

On the card a client's round is the port's ``client_round`` on a one-client
batch: the SYRK kernel on its shard, its compressor's selection kernel in
the codec's encode (the index forms), the decode of its own message and the
H update.  Every uplink leaves the card as bytes, so a round makes host
syncs per client by design.  The master decodes each message on the card
(RandK's by replaying the PRG there: the threefry kernel and TopK by keys),
stacks the clients' rows and runs the port's ``local`` aggregation ops and
``master_step`` on them.

Seed alignment: the ``local`` round draws ``key, sub = split(state.key)`` and
``split(sub, n)`` for the clients; every client replays that chain from the
shared seed and takes its own key, so no key travels and the compression
draws are the simulation's.  Masters and clients of this package and of
``repro.comm.star`` speak the same bytes, so either drives the other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.comm import protocol, wire
from repro_torch.comm.protocol import Frame, MsgType, recv_frame, send_frame
from repro_torch.comm.transport import Connection, loopback_pair
from repro_torch.compressors import get_compressor
from repro_torch.compressors.core import upload_draws
from repro_torch.core.fednl import FedNLConfig, master_step
from repro_torch.device import resolve_device
from repro_torch.linalg import frob_norm_from_packed, triu_size
from repro_torch.objectives.logreg import logreg_oracles_packed
from repro_torch.obs import core as _obs


@dataclasses.dataclass(frozen=True)
class UplinkEntry:
    """One client's uplink as the master aggregates it: the wire metadata
    (bit counters and the frame's size) and the raw uplink payload."""

    client: int
    sent_elems: int
    payload_bits: int
    frame_bytes: int
    payload: bytes


@dataclasses.dataclass
class StarRunResult:
    """Trajectory and measured wire accounting of a star run."""

    x: np.ndarray
    grad_norms: np.ndarray
    f_vals: np.ndarray
    rounds: int
    sent_bits: np.ndarray  # per round: analytic payload bits (message_bits)
    measured_payload_bits: np.ndarray  # per round: Section-7 bits counted on the wire
    measured_frame_bytes: np.ndarray  # per round: uplink frame bytes, framing included
    wall_time_s: float


def upload_vector(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float64 payload vector on ``device``."""
    return upload_draws(np.asarray(x, dtype=np.float64), device)


class StarClient:
    """One client worker: owns a data shard, serves the master's frames."""

    def __init__(
        self,
        client_id: int,
        n_clients: int,
        z_i,
        cfg: FedNLConfig,
        conn: Connection,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.client_id = client_id
        self.n_clients = n_clients
        self.device = resolve_device(device)
        z_i = torch.as_tensor(z_i, dtype=torch.float64, device=self.device)
        self._z_b = z_i[None].contiguous()  # a one-client batch
        self.cfg = cfg
        self.conn = conn
        self.d = int(z_i.shape[-1])
        self.t = triu_size(self.d)
        self.comp = get_compressor(cfg.compressor, self.t, cfg.k_for(self.d))
        self.codec = wire.make_codec(self.comp, self.t, self.device)
        self.alpha = self.comp.alpha if cfg.alpha is None else cfg.alpha
        self.key = prng.prng_key(seed)
        self.h = torch.zeros(self.t, dtype=torch.float64, device=self.device)

    def _round_key(self) -> np.ndarray:
        """The simulation's per-round key of this client: ``key, sub =
        split(key)``, then ``split(sub, n)[client_id]``."""
        self.key, sub = prng.split(self.key, 2)
        return prng.split_one(sub, self.n_clients, self.client_id)

    def _handle_init(self, frame: Frame) -> None:
        x0 = upload_vector(protocol.unpack_vector(frame.payload), self.device)
        if self.cfg.hess0 == "exact":
            self.h = logreg_oracles_packed(self._z_b, x0, self.cfg.lam)[2][0]
        elif self.cfg.hess0 == "zero":
            self.h = torch.zeros(self.t, dtype=torch.float64, device=self.device)
        else:
            raise ValueError(f"unknown hess0 {self.cfg.hess0!r}")
        send_frame(self.conn, Frame(type=MsgType.INIT_ACK, client=self.client_id,
                                    payload=protocol.pack_vector(self.h)))

    def _handle_round(self, frame: Frame) -> None:
        x = upload_vector(protocol.unpack_vector(frame.payload), self.device)
        key_i = self._round_key()
        f_i, grad_i, hess = logreg_oracles_packed(self._z_b, x, self.cfg.lam)
        delta = hess - self.h
        enc = self.codec.encode(key_i, delta[0])
        # decode our own message, so that H_i moves by exactly the correction
        # the master rebuilds
        s_i = self.codec.decode(enc.data, enc.sent_elems)
        l_i = frob_norm_from_packed(delta, self.d)
        self.h = self.h + self.alpha * s_i
        head = torch.cat([grad_i[0], l_i, f_i]).cpu().numpy()  # one copy to the host
        send_frame(self.conn, Frame(
            type=MsgType.UPLINK, round=frame.round, client=self.client_id,
            comp_id=self.codec.comp_id, sent_elems=enc.sent_elems, payload_bits=enc.bits,
            payload=protocol.pack_uplink(head[: self.d], head[self.d], head[self.d + 1], enc),
        ))

    def serve_once(self) -> bool:
        """Process one master frame; returns False on STOP."""
        frame = recv_frame(self.conn)
        if frame.type == MsgType.STOP:
            return False
        if frame.type == MsgType.INIT:
            self._handle_init(frame)
        elif frame.type == MsgType.ROUND:
            self._handle_round(frame)
        else:
            raise ValueError(f"client got unexpected frame {frame.type}")
        return True

    def run(self) -> None:
        """Blocking serve loop (TCP client processes)."""
        try:
            while self.serve_once():
                pass
        finally:
            self.conn.close()


class StarMaster:
    """Round-granular hub driver: the INIT handshake, then one FedNL round per
    :meth:`step_round`.

    ``run_star_master`` composes these into the closed event loop; the
    session backends hold a StarMaster open, and a restored session replays
    the broadcast history (:meth:`replay_round`) so that fresh clients
    rebuild their state from the spec and the PRNG spine alone.  ``drive``
    is the loopback hook, called after every broadcast so that in-process
    clients consume their frames (None over TCP).

    Subclass seams (``repro_torch.comm.topology``): ``uplink_type`` is the
    frame type a round collects (AGG for a tree master), ``_gather_uplinks``
    turns the collected frames into :class:`UplinkEntry` rows in client-id
    order, ``_on_init_ack`` / ``_on_decoded`` observe each client's state as
    it crosses the master (the elastic master's mirrors), and every master
    that claims the star's bits runs the one aggregation tail,
    ``_decode_entries`` and ``_aggregate``.
    """

    #: frame type one round of uplink collection expects from self.conns
    uplink_type = MsgType.UPLINK

    def __init__(
        self,
        conns: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        x0=None,
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        self.conns = conns
        self.order = sorted(conns)  # aggregation order == the simulation's client axis
        self.d = d
        self.cfg = cfg
        self.drive = drive
        self.device = resolve_device(device)
        t = triu_size(d)
        self.comp = get_compressor(cfg.compressor, t, cfg.k_for(d))
        self.codec = wire.make_codec(self.comp, t, self.device)
        self.alpha = self.comp.alpha if cfg.alpha is None else cfg.alpha
        if x0 is None:
            self.x = torch.zeros(d, dtype=torch.float64, device=self.device)
        else:
            self.x = torch.as_tensor(x0, dtype=torch.float64).to(self.device)
        self.h_global = None
        # the broadcast iterates, one per round: what a resumed run replays
        self.x_hist: list[np.ndarray] = []
        self._stopped = False

    def _broadcast(self, frame: Frame) -> None:
        for cid in self.order:
            send_frame(self.conns[cid], frame)
        if self.drive is not None:
            self.drive()

    def _collect(self, expect: MsgType) -> dict[int, Frame]:
        got = {}
        for cid in self.order:
            frame = recv_frame(self.conns[cid])
            if frame.type != expect or frame.client != cid:
                raise ValueError(
                    f"master expected {expect} from client {cid}, got "
                    f"{frame.type} from {frame.client}"
                )
            got[cid] = frame
        return got

    def _on_init_ack(self, cid: int, h_i: torch.Tensor) -> None:
        """Hook: one client's initial H_i^0 crossed the master."""

    def _on_decoded(self, cid: int, s_i: torch.Tensor) -> None:
        """Hook: one client's decoded correction S_i crossed the master."""

    def init_handshake(self) -> None:
        """INIT broadcast; clients report H_i^0 for the chosen hess0 policy."""
        self._broadcast(Frame(type=MsgType.INIT, payload=protocol.pack_vector(self.x)))
        acks = self._collect(MsgType.INIT_ACK)
        h = upload_vector(np.stack([protocol.unpack_vector(acks[c].payload) for c in self.order]),
                          self.device)
        for row, cid in enumerate(self.order):
            self._on_init_ack(cid, h[row])
        self.h_global = torch.mean(h, dim=0)

    def _gather_uplinks(self, r: int) -> list[UplinkEntry]:
        """One uplink frame per connection -> entries in client-id order."""
        ups = self._collect(MsgType.UPLINK)
        return [
            UplinkEntry(client=cid, sent_elems=ups[cid].sent_elems,
                        payload_bits=ups[cid].payload_bits, frame_bytes=ups[cid].wire_bytes,
                        payload=ups[cid].payload)
            for cid in self.order
        ]

    def _decode_entries(self, entries: list[UplinkEntry]):
        """Unpack and decode the entries (in the order given) into the rows the
        aggregation takes, and the round's bit counters."""
        grads, s_list, l_list, f_list = [], [], [], []
        pbits = abits = fbytes = 0
        for e in entries:
            grad_i, l_i, f_i, hess_bytes = protocol.unpack_uplink(e.payload, self.d)
            s_i = self.codec.decode(hess_bytes, e.sent_elems)
            self._on_decoded(e.client, s_i)
            s_list.append(s_i)
            grads.append(grad_i)
            l_list.append(l_i)
            f_list.append(f_i)
            pbits += e.payload_bits
            abits += wire.payload_bits(self.comp, e.sent_elems)
            fbytes += e.frame_bytes
        # each quantity as one contiguous (n_clients, ...) tensor, as the
        # local round holds it, so that the means add in the same order
        grads, l_c, f_c = (upload_vector(np.stack(v), self.device)
                           for v in (grads, l_list, f_list))
        return grads, s_list, l_c, f_c, abits, pbits, fbytes

    def _aggregate(self, entries: list[UplinkEntry]) -> dict:
        """Decode, average, Newton step: the master section of Algorithm 1,
        the ``local`` round's ops."""
        grads, s_list, l_c, f_c, abits, pbits, fbytes = self._decode_entries(entries)
        grad = torch.mean(grads, dim=0)
        s = torch.mean(torch.stack(s_list), dim=0)
        l = torch.mean(l_c)
        f = torch.mean(f_c)
        x_new = master_step(self.x, self.h_global, grad, l, self.cfg)
        self.h_global = self.h_global + self.alpha * s
        self.x = x_new
        grad_norm, f = torch.stack([torch.linalg.vector_norm(grad), f]).tolist()
        return {
            "grad_norm": grad_norm,
            "f": f,
            "sent_bits": abits,
            "measured_payload_bits": pbits,
            "measured_frame_bytes": fbytes,
        }

    def step_round(self, r: int) -> dict:
        """One protocol round: broadcast x, collect the uplinks, aggregate,
        Newton step.  Returns the round's scalar metrics and bit counters.
        With a live ``repro_torch.obs`` recorder the round is a ``comm.round``
        span labelled with host scalars only (the round, the clients, the
        measured wire counters): it reads no tensor back."""
        with _obs.CURRENT.span("comm.round", master=type(self).__name__) as sp:
            x_host = self.x.cpu().numpy()
            self._broadcast(Frame(type=MsgType.ROUND, round=r,
                                  payload=protocol.pack_vector(x_host)))
            self.x_hist.append(x_host)
            m = self._aggregate(self._gather_uplinks(r))
            sp.set(round=r, clients=len(self.order), wire_bytes=m["measured_frame_bytes"],
                   payload_bits=m["measured_payload_bits"])
            return m

    def replay_round(self, r: int, x_bcast: np.ndarray) -> None:
        """Resume: re-broadcast a recorded iterate, so that clients replay
        their round (their PRNG spine and H_i as in the original run); the
        uplinks are read and not decoded, since the master's own state comes
        from the checkpoint."""
        x_bcast = np.asarray(x_bcast, dtype=np.float64)
        self._broadcast(Frame(type=MsgType.ROUND, round=r, payload=protocol.pack_vector(x_bcast)))
        self.x_hist.append(x_bcast)
        self._collect(self.uplink_type)

    def stop(self) -> None:
        """Broadcast STOP (once), so that the clients' loops end."""
        if not self._stopped:
            self._stopped = True
            self._broadcast(Frame(type=MsgType.STOP))


def run_star_master(
    conns: dict[int, Connection],
    d: int,
    cfg: FedNLConfig,
    rounds: int = 100,
    tol: float = 0.0,
    x0=None,
    drive: Callable[[], None] | None = None,
    device: str | torch.device | None = None,
) -> StarRunResult:
    """The closed hub event loop: INIT handshake, FedNL rounds until tol or
    rounds, then STOP."""
    master = StarMaster(conns, d, cfg, x0=x0, drive=drive, device=device)
    master.init_handshake()
    grad_norms, f_vals = [], []
    bits_analytic, bits_measured, frame_bytes = [], [], []
    t_start = _obs.now()
    for r in range(rounds):
        m = master.step_round(r)
        grad_norms.append(m["grad_norm"])
        f_vals.append(m["f"])
        bits_analytic.append(m["sent_bits"])
        bits_measured.append(m["measured_payload_bits"])
        frame_bytes.append(m["measured_frame_bytes"])
        if tol > 0.0 and m["grad_norm"] < tol:
            break
    master.stop()
    return StarRunResult(
        x=master.x.cpu().numpy(),
        grad_norms=np.asarray(grad_norms),
        f_vals=np.asarray(f_vals),
        rounds=len(grad_norms),
        sent_bits=np.asarray(bits_analytic, dtype=np.int64),
        measured_payload_bits=np.asarray(bits_measured, dtype=np.int64),
        measured_frame_bytes=np.asarray(frame_bytes, dtype=np.int64),
        wall_time_s=_obs.now() - t_start,
    )


def make_loopback_clients(
    z, cfg: FedNLConfig, seed: int = 0, device: str | torch.device | None = None
) -> tuple[dict[int, Connection], Callable[[], None]]:
    """In-process client fleet: the master-side conns and the ``drive`` hook
    that lets them consume their frames.  z (n_clients, n_i, d) goes to the
    device once; each client holds its row."""
    device = resolve_device(device)
    z = torch.as_tensor(z, dtype=torch.float64).to(device)
    n_clients = z.shape[0]
    master_conns: dict[int, Connection] = {}
    clients: list[StarClient] = []
    for i in range(n_clients):
        a, b = loopback_pair()
        master_conns[i] = a
        clients.append(StarClient(i, n_clients, z[i], cfg, b, seed=seed, device=device))
    pending = [True] * n_clients

    def drive() -> None:
        for i, c in enumerate(clients):
            if pending[i]:
                pending[i] = c.serve_once()

    return master_conns, drive


def run_loopback(
    z,
    cfg: FedNLConfig,
    rounds: int = 100,
    tol: float = 0.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> StarRunResult:
    """A whole protocol run over in-process loopback connections (one
    thread): every message crosses encode -> frame -> decode."""
    d = z.shape[-1]
    master_conns, drive = make_loopback_clients(z, cfg, seed=seed, device=device)
    return run_star_master(master_conns, d, cfg, rounds=rounds, tol=tol, drive=drive,
                           device=device)
