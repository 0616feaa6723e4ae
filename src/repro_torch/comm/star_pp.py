"""Star-topology FedNL-PP: partial participation over the wire (port of
``repro.comm.star_pp``).

Algorithm 3 of FedNL as a master/client protocol: the server stores only the
invariants ``H^k`` (packed), ``l^k``, ``g^k`` and recovers the model as
``x^{k+1} = (H^k + l^k I)^{-1} g^k``; each round it samples tau clients
u.a.r. and sends each a SELECT frame (its slot in the sample, tau, the
iterate); only those clients compute, and uplink ``encode(S_i) || dl_i ||
dg_i`` (PP_UPDATE).  The master keeps

    H += (alpha/n) * sum_i S_i,   l += sum_i dl_i / n,   g += sum_i dg_i / n

On the card a selected client runs the ``local`` PP round's client lines on a
one-client batch (the SYRK kernel, the codec's selection kernel, the decode
of its own message, the H, l, g update); the master decodes on the card.

Seed alignment: the simulation draws ``key, k_sel, k_comp = split(key, 3)``
per round, samples with ``k_sel`` and gives slot j the key ``split(k_comp,
tau)[j]``.  The master owns that chain; each client replays ``key ->
split(key, 3)[0]`` up to the round in the SELECT header and takes its slot's
key.  Faults (``transport.FaultSpec``): a client drops a SELECT (a DROP
frame) or stalls; ``on_dropout="partial"`` goes on with the survivors' sum
(the /n never changes), ``"resample"`` draws a replacement from the clients
not yet selected, ``randint(fold_in(k_sel, 1 + attempt), 0, len(pool))``,
which inherits the dropped client's slot and so its key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.comm import protocol, wire
from repro_torch.comm.protocol import Frame, MsgType, recv_frame, send_frame
from repro_torch.comm.star import upload_vector
from repro_torch.comm.transport import Connection, FaultInjector, FaultSpec, loopback_pair
from repro_torch.compressors import get_compressor
from repro_torch.core.fednl import FedNLConfig
from repro_torch.core.fednl_pp import _shifted_apply
from repro_torch.device import resolve_device
from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, triu_size, unpack_triu
from repro_torch.objectives.logreg import logreg_oracles_packed
from repro_torch.obs import core as _obs


@dataclasses.dataclass
class StarPPRunResult:
    """Per-round trajectory and measured wire accounting of a PP star run."""

    x: np.ndarray  # final model (from the invariants after the run)
    x_hist: np.ndarray  # (rounds, d): the model produced each round
    l_hist: np.ndarray  # (rounds,): the server's l^k before each update
    rounds: int
    participants: list[list[int]]  # client ids that contributed, per round
    dropped: list[list[int]]  # client ids that dropped, per round
    sent_bits: np.ndarray  # per round: analytic pp_message_bits total
    measured_payload_bits: np.ndarray  # per round: bits counted on the wire
    measured_frame_bytes: np.ndarray  # per round: framed PP_UPDATE bytes
    wall_time_s: float


class StarPPClient:
    """One PP client worker: owns a shard and its (H_i, l_i, g_i).  Its state
    changes only on SELECT."""

    def __init__(
        self,
        client_id: int,
        n_clients: int,
        z_i,
        cfg: FedNLConfig,
        conn: Connection,
        seed: int = 0,
        fault: FaultSpec | None = None,
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
        self.fault = FaultInjector(fault, client_id) if fault and fault.active else None
        # lazy replay of the master's per-round key spine
        self._key = prng.prng_key(seed)
        self._round = 0
        self.h = torch.zeros((1, self.t), dtype=torch.float64, device=self.device)
        self.l = torch.zeros(1, dtype=torch.float64, device=self.device)
        self.g = torch.zeros((1, self.d), dtype=torch.float64, device=self.device)

    def _comp_key(self, rnd: int, slot: int, tau: int) -> np.ndarray:
        """``split(k_comp, tau)[slot]`` of round ``rnd``, reached by replaying
        the key spine up to it."""
        while self._round < rnd:
            self._key = prng.split(self._key, 3)[0]
            self._round += 1
        k_comp = prng.split(self._key, 3)[2]
        return prng.split_one(k_comp, tau, slot)

    def _send_state(self, frame_type: MsgType, rnd: int, payload: bytes, **fields) -> None:
        send_frame(self.conn, Frame(type=frame_type, round=rnd, client=self.client_id,
                                    payload=payload, **fields))

    def _handle_init(self, frame: Frame) -> None:
        """``fednl_pp_init``'s client lines: H_i^0 by hess0, l_i^0, g_i^0."""
        x0 = upload_vector(protocol.unpack_vector(frame.payload), self.device)
        _, grad, hess = logreg_oracles_packed(self._z_b, x0, self.cfg.lam)
        if self.cfg.hess0 == "exact":
            h = hess
        elif self.cfg.hess0 == "zero":
            h = torch.zeros_like(hess)
        else:
            raise ValueError(f"unknown hess0 {self.cfg.hess0!r}")
        self.h = h
        self.l = frob_norm_from_packed(h - hess, self.d)
        self.g = _shifted_apply(h, self.l, x0, self.d) - grad
        state = torch.cat([self.h[0], self.l, self.g[0]]).cpu().numpy()
        self._send_state(MsgType.INIT_ACK, 0, protocol.pack_pp_state(
            state[: self.t], state[self.t], state[self.t + 1 :]))

    def _handle_select(self, frame: Frame) -> None:
        """Algorithm 3, lines 9-13, for one sampled client, or a fault."""
        if self.fault is not None:
            if self.fault.should_drop():
                self._send_state(MsgType.DROP, frame.round, b"")
                return
            self.fault.maybe_stall()
        slot, tau, x = protocol.unpack_select(frame.payload)
        x = upload_vector(x, self.device)
        key_i = self._comp_key(frame.round, slot, tau)
        _, grad, d_i = logreg_oracles_packed(self._z_b, x, self.cfg.lam)
        enc = self.codec.encode(key_i, (d_i - self.h)[0])
        # decode our own message, so that H_i moves by exactly the correction
        # the master rebuilds
        s_i = self.codec.decode(enc.data, enc.sent_elems)
        h_new = self.h + self.alpha * s_i[None]
        l_new = frob_norm_from_packed(h_new - d_i, self.d)
        g_new = _shifted_apply(h_new, l_new, x, self.d) - grad
        deltas = torch.cat([l_new - self.l, (g_new - self.g)[0]]).cpu().numpy()
        self.h, self.l, self.g = h_new, l_new, g_new
        self._send_state(
            MsgType.PP_UPDATE, frame.round,
            protocol.pack_pp_update(enc, deltas[0], deltas[1:]),
            comp_id=self.codec.comp_id, sent_elems=enc.sent_elems,
            payload_bits=enc.bits + (self.d + 1) * wire.FP_BITS,
        )

    def serve_once(self) -> bool:
        """Process one master frame; returns False on STOP."""
        frame = recv_frame(self.conn)
        if frame.type == MsgType.STOP:
            return False
        if frame.type == MsgType.INIT:
            self._handle_init(frame)
        elif frame.type == MsgType.SELECT:
            self._handle_select(frame)
        else:
            raise ValueError(f"PP client got unexpected frame {frame.type}")
        return True

    def run(self) -> None:
        """Blocking serve loop (TCP client processes)."""
        try:
            while self.serve_once():
                pass
        finally:
            self.conn.close()


class StarPPMaster:
    """The PP hub: owns the invariants, samples, collects, aggregates."""

    def __init__(
        self,
        conns: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        tau: int,
        seed: int = 0,
        x0=None,
        on_dropout: str = "partial",
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        if on_dropout not in ("partial", "resample"):
            raise ValueError(f"unknown on_dropout {on_dropout!r}")
        if not 0 < tau <= len(conns):
            raise ValueError(f"need 0 < tau <= n, got tau={tau}, n={len(conns)}")
        self.conns = conns
        self.order = sorted(conns)
        self.n_clients = len(conns)
        self.d = d
        self.t = triu_size(d)
        self.cfg = cfg
        self.tau = tau
        self.on_dropout = on_dropout
        self.drive = drive
        self.device = resolve_device(device)
        self.comp = get_compressor(cfg.compressor, self.t, cfg.k_for(d))
        self.codec = wire.make_codec(self.comp, self.t, self.device)
        self.alpha = self.comp.alpha if cfg.alpha is None else cfg.alpha
        self.eye = torch.eye(d, dtype=torch.float64, device=self.device)
        self.key = prng.prng_key(seed)
        if x0 is None:
            self.x0 = torch.zeros(d, dtype=torch.float64, device=self.device)
        else:
            self.x0 = torch.as_tensor(x0, dtype=torch.float64).to(self.device)
        self.h_global = None
        self.l_global = None
        self.g_global = None
        self._stopped = False

    def _drive(self) -> None:
        if self.drive is not None:
            self.drive()

    def _init_handshake(self) -> None:
        """INIT broadcast; every client reports (H_i^0, l_i^0, g_i^0)."""
        for cid in self.order:
            send_frame(self.conns[cid],
                       Frame(type=MsgType.INIT, payload=protocol.pack_vector(self.x0)))
        self._drive()
        h_list, l_list, g_list = [], [], []
        for cid in self.order:
            frame = recv_frame(self.conns[cid])
            if frame.type != MsgType.INIT_ACK or frame.client != cid:
                raise ValueError(
                    f"master expected INIT_ACK from {cid}, got {frame.type} from {frame.client}"
                )
            h_i, l_i, g_i = protocol.unpack_pp_state(frame.payload, self.d)
            h_list.append(h_i)
            l_list.append(l_i)
            g_list.append(g_i)
        # the means of fednl_pp_init, on (n_clients, ...) tensors
        h, l, g = (upload_vector(np.stack(v), self.device) for v in (h_list, l_list, g_list))
        self.h_global = torch.mean(h, dim=0)
        self.l_global = torch.mean(l)
        self.g_global = torch.mean(g, dim=0)

    def _solve_x(self) -> torch.Tensor:
        """x = (H + l I)^{-1} g: Algorithm 3, line 4."""
        h = unpack_triu(self.h_global, self.d)
        return cholesky_solve(h + self.l_global * self.eye, self.g_global)

    def _select(self, cid: int, rnd: int, slot: int, x: np.ndarray) -> None:
        send_frame(self.conns[cid], Frame(type=MsgType.SELECT, round=rnd, client=cid,
                                          payload=protocol.pack_select(slot, self.tau, x)))

    def _sample_round(self, r: int, x: np.ndarray) -> tuple[list[int], np.ndarray]:
        """Advance the key spine one round and SELECT the sampled cohort."""
        key, k_sel, _k_comp = prng.split(self.key, 3)
        self.key = key
        idx = [int(i) for i in prng.choice(k_sel, self.n_clients, (self.tau,), replace=False)]
        for slot, cid in enumerate(idx):
            self._select(cid, r, slot, x)
        self._drive()
        return idx, k_sel

    def _collect_round(self, r: int, x: np.ndarray, idx: list[int], k_sel, decode: bool):
        """Collect one round's PP_UPDATE / DROP replies slot by slot,
        resampling by ``on_dropout``.  ``decode=False`` (a checkpoint's replay)
        reads the uplinks and does not decode them."""
        pool = [c for c in self.order if c not in set(idx)]
        attempt = 0
        s_list, dl_list, dg_list = [], [], []
        participants, dropped = [], []
        round_abits = round_mbits = round_fbytes = 0
        for slot, cid in enumerate(idx):
            cur = cid
            while True:
                fr = recv_frame(self.conns[cur])
                if fr.type == MsgType.PP_UPDATE:
                    if decode:
                        hess_bytes, dl, dg = protocol.unpack_pp_update(fr.payload, self.d)
                        s_list.append(self.codec.decode(hess_bytes, fr.sent_elems))
                        dl_list.append(dl)
                        dg_list.append(dg)
                    participants.append(cur)
                    round_abits += int(wire.pp_message_bits(
                        self.comp, torch.as_tensor(fr.sent_elems), self.d))
                    round_mbits += fr.payload_bits
                    round_fbytes += fr.wire_bytes
                    break
                if fr.type != MsgType.DROP:
                    raise ValueError(f"master expected PP_UPDATE/DROP, got {fr.type}")
                dropped.append(cur)
                if self.on_dropout == "resample" and pool:
                    # the replacement inherits the slot, and so its key
                    rk = prng.fold_in(k_sel, 1 + attempt)
                    attempt += 1
                    cur = pool.pop(int(prng.randint(rk, 0, len(pool))))
                    self._select(cur, r, slot, x)
                    self._drive()
                    continue
                break  # partial: this slot contributes nothing
        return (s_list, dl_list, dg_list, participants, dropped,
                round_abits, round_mbits, round_fbytes)

    def step_round(self, r: int) -> dict:
        """One Algorithm-3 round: x from the invariants, tau clients sampled,
        their deltas collected (dropouts handled), the invariants updated.
        With a live ``repro_torch.obs`` recorder, a ``comm.round`` span of host
        scalars."""
        with _obs.CURRENT.span("comm.round", master=type(self).__name__) as sp:
            m = self._step_round_inner(r)
            sp.set(round=r, participants=m["participants"], dropped=m["dropped"],
                   wire_bytes=m["measured_frame_bytes"], payload_bits=m["measured_payload_bits"])
            return m

    def _step_round_inner(self, r: int) -> dict:
        n = self.n_clients
        x = self._solve_x()
        head = torch.cat([x, self.l_global.reshape(1)]).cpu().numpy()
        x_host, l_pre = head[: self.d], float(head[self.d])
        idx, k_sel = self._sample_round(r, x_host)
        (s_list, dl_list, dg_list, participants, dropped,
         round_abits, round_mbits, round_fbytes) = self._collect_round(
            r, x_host, idx, k_sel, decode=True)
        # Algorithm 3, lines 18-20; absent clients add zero, the /n stays
        if s_list:
            dl, dg = (upload_vector(np.stack(v), self.device) for v in (dl_list, dg_list))
            self.h_global = self.h_global + (self.alpha / n) * torch.sum(torch.stack(s_list), dim=0)
            self.l_global = self.l_global + torch.sum(dl) / n
            self.g_global = self.g_global + torch.sum(dg, dim=0) / n
        return {
            "x": x_host,
            "l": l_pre,
            "participants": participants,
            "dropped": dropped,
            "sent_bits": round_abits,
            "measured_payload_bits": round_mbits,
            "measured_frame_bytes": round_fbytes,
        }

    def replay_round(self, r: int, x_rec: np.ndarray) -> None:
        """Resume: re-drive round ``r`` with the recorded iterate, so that fresh
        clients replay their Algorithm-3 bodies (key spine, fault draws, H_i,
        l_i, g_i) as in the original run; the uplinks are read and not
        decoded, and the invariants stay as the checkpoint restores them."""
        x = np.asarray(x_rec, dtype=np.float64)
        idx, k_sel = self._sample_round(r, x)
        self._collect_round(r, x, idx, k_sel, decode=False)

    def stop(self) -> None:
        """Send STOP to every client (once), so that their loops end."""
        if self._stopped:
            return
        self._stopped = True
        for cid in self.order:
            send_frame(self.conns[cid], Frame(type=MsgType.STOP))
        self._drive()

    def run(self, rounds: int) -> StarPPRunResult:
        self._init_handshake()
        ms = []
        t_start = _obs.now()
        for r in range(rounds):
            ms.append(self.step_round(r))
        self.stop()
        wall = _obs.now() - t_start
        return StarPPRunResult(
            x=self._solve_x().cpu().numpy(),
            x_hist=np.asarray([m["x"] for m in ms]).reshape(rounds, self.d),
            l_hist=np.asarray([m["l"] for m in ms]),
            rounds=rounds,
            participants=[m["participants"] for m in ms],
            dropped=[m["dropped"] for m in ms],
            sent_bits=np.asarray([m["sent_bits"] for m in ms], dtype=np.int64),
            measured_payload_bits=np.asarray([m["measured_payload_bits"] for m in ms],
                                             dtype=np.int64),
            measured_frame_bytes=np.asarray([m["measured_frame_bytes"] for m in ms],
                                            dtype=np.int64),
            wall_time_s=wall,
        )


def make_pp_loopback_clients(
    z,
    cfg: FedNLConfig,
    seed: int = 0,
    fault: FaultSpec | None = None,
    device: str | torch.device | None = None,
) -> tuple[dict[int, Connection], Callable[[], None]]:
    """In-process PP client fleet: the master-side conns and the on-demand
    ``drive`` hook (only SELECTed clients have frames in a PP round)."""
    device = resolve_device(device)
    z = torch.as_tensor(z, dtype=torch.float64).to(device)
    n_clients = z.shape[0]
    master_conns: dict[int, Connection] = {}
    clients: list[StarPPClient] = []
    for i in range(n_clients):
        a, b = loopback_pair()
        master_conns[i] = a
        clients.append(StarPPClient(i, n_clients, z[i], cfg, b, seed=seed, fault=fault,
                                    device=device))

    def drive() -> None:
        for c in clients:
            while c.conn.pending():
                if not c.serve_once():
                    break

    return master_conns, drive


def run_pp_loopback(
    z,
    cfg: FedNLConfig,
    tau: int,
    rounds: int = 100,
    seed: int = 0,
    on_dropout: str = "partial",
    fault: FaultSpec | None = None,
    device: str | torch.device | None = None,
) -> StarPPRunResult:
    """A whole FedNL-PP protocol run over in-process loopback connections."""
    d = z.shape[-1]
    master_conns, drive = make_pp_loopback_clients(z, cfg, seed=seed, fault=fault, device=device)
    master = StarPPMaster(master_conns, d, cfg, tau, seed=seed, on_dropout=on_dropout,
                          drive=drive, device=device)
    return master.run(rounds)
