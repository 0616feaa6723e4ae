"""The topology layer above the star transports (port of
``repro.comm.topology``).

The flat star of ``repro_torch.comm.star`` has every client dial one master
and every round wait for all of them.  This module adds, above the same
framed protocol and without touching the client:

  * **Tree of stars** (:class:`TopologySpec` kind="tree"): intermediate
    :class:`AggregatorNode` s each own a subtree, keep the server invariant
    on its partial sums (h_sub += alpha * sum_i S_i) and forward ONE
    combined uplink per subtree (AGG frames).  ``combine="exact"`` (the
    default) carries the subtree's leaf uplink sections verbatim, so that
    the root runs the flat star's aggregation over the reassembled leaf list
    and the tree's trajectory is the star's bit for bit, at any depth.
    ``combine="sum"`` carries dense partial sums instead (one T-vector per
    subtree, not per client), at the cost of the FP64 sums' reassociation.

  * **Bounded-staleness asynchronous aggregation** (mode="async"): the root
    assigns work to idle clients each round and folds an update computed
    against x^r into the invariant no later than commit ``r + staleness``;
    staleness=0 is the synchronous barrier bit for bit.  Arrival delays are
    a function of ``(schedule_seed, round, client)`` alone, so a run and its
    restore by replay are set by the spec.

  * **Elastic membership** (:class:`MembershipSpec`): join and leave events
    of the spec.  A joining client builds H_i by a late INIT at the current
    iterate (its T*64-bit ack counted into that round's uplink exactly); a
    leaving client's contribution is retired by recomputing the invariant
    as the mean of the master's mirrors of the remaining H_i.

On the card every master and aggregator decodes on its own device: with
RandK each decode replays the PRG there (the threefry kernel and TopK by
keys' index form), so an exact tree decodes each leaf's message once per
hop.  Payload vectors cross as host bytes; tensors stay on the node's
device between frames.  The async schedule and the tree's resolution are
host numpy, as the reference's.

Construction goes through :func:`make_master` / :func:`open_loopback_master`.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.comm import protocol, wire
from repro_torch.comm.protocol import Frame, MsgType, recv_frame, send_frame
from repro_torch.comm.star import (
    StarClient,
    StarMaster,
    UplinkEntry,
    make_loopback_clients,
    upload_vector,
)
from repro_torch.comm.transport import Connection, loopback_pair
from repro_torch.compressors import get_compressor
from repro_torch.core.fednl import FedNLConfig, master_step
from repro_torch.device import resolve_device
from repro_torch.linalg import triu_size
from repro_torch.obs import core as _obs

_COMBINE_IDS = {"exact": 0, "sum": 1}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """How client updates reach the root.

    kind="star" is the flat star; kind="tree" inserts aggregators: a
    balanced tree (``fanout`` children per node, ``depth`` hops from the
    root to a leaf: depth=2 is root -> aggregators -> clients) or an
    explicit ``edges`` grouping (a tuple of client-id tuples, one per depth-2
    aggregator).  ``combine`` picks the AGG payload: "exact" keeps the
    star's bits, "sum" sends one dense sum per subtree.

    mode="async" (star kind only) replaces the round barrier with bounded
    staleness: an update computed against x^r is applied no later than
    commit r + ``staleness``; each (round, client)'s arrival delay is drawn
    from ``numpy.random.default_rng((schedule_seed, round, client))`` over
    [0, max_delay], so the schedule is part of the spec, not of the clock.
    """

    kind: str = "star"  # "star" | "tree"
    fanout: int = 2  # balanced tree: children per internal node
    depth: int = 2  # hops root -> leaf (2 = one aggregator layer)
    edges: tuple[tuple[int, ...], ...] | None = None  # explicit depth-2 groups
    combine: str = "exact"  # "exact" (the star's bits) | "sum" (partial sums)
    mode: str = "sync"  # "sync" | "async" (bounded staleness; star only)
    staleness: int = 0  # async: most commits an in-flight update may lag
    max_delay: int = 0  # async: delays drawn from [0, max_delay]
    schedule_seed: int = 0  # async: arrival schedule seed

    def __post_init__(self):
        if self.kind not in ("star", "tree"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        if self.combine not in _COMBINE_IDS:
            raise ValueError(f"unknown combine {self.combine!r}; use 'exact' | 'sum'")
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown topology mode {self.mode!r}")
        if self.kind == "tree":
            if self.mode == "async":
                raise ValueError(
                    "async aggregation composes with the star kind only "
                    "(an async tree would need per-subtree staleness "
                    "contracts; spec one layer at a time)"
                )
            if self.edges is None and (self.fanout < 2 or self.depth < 2):
                raise ValueError(
                    f"a balanced tree needs fanout >= 2 and depth >= 2, got "
                    f"fanout={self.fanout}, depth={self.depth}"
                )
        if self.staleness < 0 or self.max_delay < 0:
            raise ValueError("staleness and max_delay must be >= 0")
        if self.mode == "sync" and self.staleness > 0:
            raise ValueError("staleness > 0 requires mode='async'")

    @property
    def trivial(self) -> bool:
        """True for the plain flat synchronous star (the default, as
        topology=None)."""
        return self.kind == "star" and self.mode == "sync"

    def resolve(self, n_clients: int) -> tuple:
        """The root's children as a tuple of subtrees; a subtree is a tuple
        of leaf client ids (ints) or of nested subtrees.  A balanced tree
        splits the id range contiguously (``np.array_split``); explicit
        ``edges`` must partition ``range(n_clients)``."""
        if self.kind != "tree":
            raise ValueError("resolve() applies to tree topologies only")
        if self.edges is not None:
            groups = tuple(tuple(int(i) for i in g) for g in self.edges)
            flat = sorted(i for g in groups for i in g)
            if flat != list(range(n_clients)) or any(not g for g in groups):
                raise ValueError(
                    f"edges must partition client ids 0..{n_clients - 1} "
                    f"into non-empty groups, got {self.edges!r}"
                )
            return groups

        def build(ids: list[int], depth: int) -> tuple:
            if depth <= 1:
                return tuple(ids)
            k = min(self.fanout, len(ids))
            chunks = [[int(i) for i in c] for c in np.array_split(ids, k) if len(c)]
            return tuple(build(c, depth - 1) for c in chunks)

        if n_clients < self.fanout:
            raise ValueError(f"tree fanout {self.fanout} exceeds n_clients={n_clients}")
        return build(list(range(n_clients)), self.depth)


def subtree_leaves(subtree) -> list[int]:
    """A resolve() subtree's leaf client ids, sorted."""
    out: list[int] = []
    for node in subtree:
        if isinstance(node, (tuple, list)):
            out.extend(subtree_leaves(node))
        else:
            out.append(int(node))
    return sorted(out)


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership event, applied at the START of ``round``."""

    round: int
    action: str  # "join" | "leave"
    client: int

    def __post_init__(self):
        if self.action not in ("join", "leave"):
            raise ValueError(f"unknown membership action {self.action!r}")
        if self.round < 0 or self.client < 0:
            raise ValueError("membership round and client must be >= 0")


@dataclasses.dataclass(frozen=True)
class MembershipSpec:
    """A join/leave schedule.  Clients with a ``join`` event sit out
    (connected, idle) until their round; ``leave`` retires a client's
    contribution from the invariant exactly.  The events are part of the
    spec, so a restored session replays the same cohort history."""

    events: tuple[MembershipEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    @property
    def trivial(self) -> bool:
        return not self.events

    def initial_active(self, n_clients: int) -> list[int]:
        """Clients active from round 0: all without a join event."""
        joiners = {e.client for e in self.events if e.action == "join"}
        bad = [e.client for e in self.events if e.client >= n_clients]
        if bad:
            raise ValueError(
                f"membership events name clients {sorted(set(bad))} outside "
                f"0..{n_clients - 1}"
            )
        active = [i for i in range(n_clients) if i not in joiners]
        if not active:
            raise ValueError("membership schedule leaves round 0 empty")
        return active

    def events_at(self, r: int) -> list[MembershipEvent]:
        return [e for e in self.events if e.round == r]


# ---------------------------------------------------------------------------
# AggregatorNode: one subtree's hub
# ---------------------------------------------------------------------------


class AggregatorNode:
    """An intermediate hub: serves its parent as a client does and drives
    its children as a master does.

    A round fans the broadcast down, collects one frame per child (UPLINK
    from leaves, AGG from sub-aggregators), keeps the server invariant on
    the subtree's partial sums (h_sub += alpha * sum_i S_i, each S_i decoded
    on the node's device) and sends one AGG frame up: the leaf sections
    verbatim with combine="exact", the dense sums with combine="sum".

    ``agg_children`` names the child connections that lead to
    sub-aggregators (the SUBTREE handshake goes to them only); ``drive`` is
    the loopback hook that lets in-process children consume their frames.
    """

    def __init__(
        self,
        node_id: int,
        parent: Connection,
        children: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        combine: str = "exact",
        agg_children: frozenset[int] | set[int] = frozenset(),
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        self.node_id = node_id
        self.parent = parent
        self.children = children
        self.corder = sorted(children)
        self.d = d
        self.cfg = cfg
        self.combine = combine
        self.agg_children = frozenset(agg_children)
        self.drive = drive
        self.device = resolve_device(device)
        t = triu_size(d)
        self.t = t
        self.comp = get_compressor(cfg.compressor, t, cfg.k_for(d))
        self.codec = wire.make_codec(self.comp, t, self.device)
        self.alpha = self.comp.alpha if cfg.alpha is None else cfg.alpha
        self.h_sub = None  # sum of the subtree's H_i (the invariant on partial sums)
        self.leaf_count = 0

    def _fan_down(self, frame: Frame) -> None:
        for c in self.corder:
            send_frame(self.children[c], frame)
        if self.drive is not None:
            self.drive()

    def _collect_entries(self, leaf_type: MsgType) -> list[tuple]:
        """One frame per child -> the flat leaf entry list in client-id order
        (a sub-aggregator's AGG entries concatenate in)."""
        entries: list[tuple] = []
        for c in self.corder:
            fr = recv_frame(self.children[c])
            if fr.type == MsgType.AGG:
                entries.extend(protocol.unpack_agg_entries(fr.payload))
            elif fr.type == leaf_type:
                entries.append((fr.client, fr.sent_elems, fr.payload_bits, fr.wire_bytes,
                                fr.payload))
            else:
                raise ValueError(
                    f"aggregator {self.node_id} expected {leaf_type} | AGG "
                    f"from child {c}, got {fr.type}"
                )
        entries.sort(key=lambda e: e[0])
        return entries

    def _reply(self, frame_round: int, payload: bytes) -> None:
        send_frame(self.parent, Frame(type=MsgType.AGG, round=frame_round, client=self.node_id,
                                      payload=payload))

    def _handle_subtree(self, frame: Frame) -> None:
        combine_id, expected = protocol.unpack_subtree(frame.payload)
        if combine_id != _COMBINE_IDS[self.combine]:
            raise ValueError(
                f"aggregator {self.node_id} wired combine={self.combine!r} "
                f"but the master announced combine id {combine_id}"
            )
        owned: list[int] = []
        for c in self.corder:
            if c in self.agg_children:
                send_frame(self.children[c], Frame(
                    type=MsgType.SUBTREE, payload=protocol.pack_subtree(combine_id, ())))
            else:
                owned.append(c)  # leaf connections are keyed by client id
        if self.drive is not None:
            self.drive()
        for c in self.corder:
            if c in self.agg_children:
                ack = recv_frame(self.children[c])
                if ack.type != MsgType.SUBTREE:
                    raise ValueError(
                        f"aggregator {self.node_id} expected SUBTREE ack "
                        f"from child {c}, got {ack.type}"
                    )
                owned.extend(protocol.unpack_subtree(ack.payload)[1])
        owned = sorted(owned)
        if expected and list(expected) != owned:
            raise ValueError(
                f"subtree {self.node_id} owns leaves {owned} but the master "
                f"expected {sorted(expected)} — mis-wired process tree"
            )
        self.leaf_count = len(owned)
        send_frame(self.parent, Frame(type=MsgType.SUBTREE, client=self.node_id,
                                      payload=protocol.pack_subtree(combine_id, owned)))

    def _handle_init(self, frame: Frame) -> None:
        self._fan_down(frame)
        if self.combine == "exact":
            entries = self._collect_entries(MsgType.INIT_ACK)
            h = upload_vector(np.stack([protocol.unpack_vector(e[4]) for e in entries]),
                              self.device)
            self.h_sub = torch.sum(h, dim=0)
            self._reply(frame.round, protocol.pack_agg_entries(entries))
            return
        # combine="sum": leaf vectors and sub-aggregators' sums into one dense sum
        count = 0
        h_list = []
        for c in self.corder:
            fr = recv_frame(self.children[c])
            if fr.type == MsgType.AGG:
                sub_count, sub_h = protocol.unpack_agg_hsum(fr.payload)
                count += sub_count
                h_list.append(sub_h)
            elif fr.type == MsgType.INIT_ACK:
                count += 1
                h_list.append(protocol.unpack_vector(fr.payload))
            else:
                raise ValueError(
                    f"aggregator {self.node_id} expected INIT_ACK | AGG, got {fr.type}"
                )
        self.h_sub = torch.sum(upload_vector(np.stack(h_list), self.device), dim=0)
        self._reply(frame.round, protocol.pack_agg_hsum(count, self.h_sub))

    def _handle_round(self, frame: Frame) -> None:
        # the hop's latency: fan-down, the children's collection and the reply
        # (host timing only; the aggregation is untouched)
        with _obs.CURRENT.span("comm.hop", node=self.node_id, round=frame.round,
                               children=len(self.corder), combine=self.combine):
            self._handle_round_inner(frame)

    def _handle_round_inner(self, frame: Frame) -> None:
        self._fan_down(frame)
        if self.combine == "exact":
            entries = self._collect_entries(MsgType.UPLINK)
            s_list = [self.codec.decode(protocol.unpack_uplink(e[4], self.d)[3], e[1])
                      for e in entries]
            # the subtree's server invariant on partial sums
            self.h_sub = self.h_sub + self.alpha * torch.sum(torch.stack(s_list), dim=0)
            self._reply(frame.round, protocol.pack_agg_entries(entries))
            return
        count = abits = pbits = fbytes = 0
        grad_list, s_list, l_parts, f_parts = [], [], [], []
        for c in self.corder:
            fr = recv_frame(self.children[c])
            if fr.type == MsgType.AGG:
                sub_n, sub_a, sub_p, sub_f, sub_l, sub_fv, sub_grad, sub_s = (
                    protocol.unpack_agg_roundsum(fr.payload))
                count += sub_n
                abits += sub_a
                pbits += sub_p
                fbytes += sub_f
                l_parts.append(sub_l)
                f_parts.append(sub_fv)
                grad_list.append(sub_grad)
                s_list.append(upload_vector(sub_s, self.device))
            elif fr.type == MsgType.UPLINK:
                grad_i, l_i, f_i, hess_bytes = protocol.unpack_uplink(fr.payload, self.d)
                count += 1
                abits += wire.payload_bits(self.comp, fr.sent_elems)
                pbits += fr.payload_bits
                fbytes += fr.wire_bytes
                l_parts.append(l_i)
                f_parts.append(f_i)
                grad_list.append(grad_i)
                s_list.append(self.codec.decode(hess_bytes, fr.sent_elems))
            else:
                raise ValueError(
                    f"aggregator {self.node_id} expected UPLINK | AGG, got {fr.type}"
                )
        grad_sum = torch.sum(upload_vector(np.stack(grad_list), self.device), dim=0)
        s_sum = torch.sum(torch.stack(s_list), dim=0)
        lf_sum = torch.sum(upload_vector(np.stack([l_parts, f_parts]), self.device), dim=1)
        self.h_sub = self.h_sub + self.alpha * s_sum
        head = torch.cat([lf_sum, grad_sum, s_sum]).cpu().numpy()  # one copy to the host
        self._reply(frame.round, protocol.pack_agg_roundsum(
            count, self.d, abits, pbits, fbytes, head[0], head[1], head[2 : 2 + self.d],
            head[2 + self.d :]))

    def serve_once(self) -> bool:
        """Process one parent frame; returns False on STOP."""
        frame = recv_frame(self.parent)
        if frame.type == MsgType.STOP:
            self._fan_down(frame)
            return False
        if frame.type == MsgType.SUBTREE:
            self._handle_subtree(frame)
        elif frame.type == MsgType.INIT:
            self._handle_init(frame)
        elif frame.type == MsgType.ROUND:
            self._handle_round(frame)
        else:
            raise ValueError(f"aggregator {self.node_id} got unexpected frame {frame.type}")
        return True

    def run(self) -> None:
        """Blocking serve loop (TCP aggregator processes)."""
        while self.serve_once():
            pass


def build_aggregator(
    node_id: int,
    parent: Connection,
    children: dict[int, Connection],
    d: int,
    cfg: FedNLConfig,
    combine: str = "exact",
    agg_children: frozenset[int] | set[int] = frozenset(),
    drive: Callable[[], None] | None = None,
    device: str | torch.device | None = None,
) -> AggregatorNode:
    """The construction seam of an aggregator outside this module (the TCP
    launcher runs each in a process of its own)."""
    return AggregatorNode(node_id, parent, children, d, cfg, combine=combine,
                          agg_children=agg_children, drive=drive, device=device)


# ---------------------------------------------------------------------------
# TreeMaster: the root of a tree of stars
# ---------------------------------------------------------------------------


class TreeMaster(StarMaster):
    """A StarMaster whose connections lead to aggregators, not clients.

    combine="exact": the AGG payloads are reassembled into the flat leaf
    entry list (client-id order) and fed to the inherited aggregation tail:
    the same ops on the same operands, so the trajectory and the measured
    bit accounting are the flat star's.  combine="sum": the partial sums are
    summed, then divided by n once.
    """

    uplink_type = MsgType.AGG

    def __init__(
        self,
        conns: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        topology: TopologySpec,
        n_clients: int,
        x0=None,
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(conns, d, cfg, x0=x0, drive=drive, device=device)
        self.topology = topology
        self.n_clients = n_clients
        self.combine = topology.combine
        shape = topology.resolve(n_clients)
        if len(shape) != len(conns):
            raise ValueError(
                f"topology resolves to {len(shape)} root subtrees but "
                f"{len(conns)} aggregator connections are wired"
            )
        self._expected = {i: subtree_leaves(shape[i]) for i in self.order}

    def _subtree_handshake(self) -> None:
        combine_id = _COMBINE_IDS[self.combine]
        for i in self.order:
            send_frame(self.conns[i], Frame(
                type=MsgType.SUBTREE, payload=protocol.pack_subtree(combine_id, self._expected[i])))
        if self.drive is not None:
            self.drive()
        covered: list[int] = []
        for i in self.order:
            ack = recv_frame(self.conns[i])
            if ack.type != MsgType.SUBTREE or ack.client != i:
                raise ValueError(
                    f"expected SUBTREE ack from aggregator {i}, got "
                    f"{ack.type} from {ack.client}"
                )
            covered.extend(protocol.unpack_subtree(ack.payload)[1])
        if sorted(covered) != list(range(self.n_clients)):
            raise ValueError(
                f"subtree acks cover leaves {sorted(covered)}, not the "
                f"client id partition 0..{self.n_clients - 1}"
            )

    def _entries_from_aggs(self, frames: dict[int, Frame]) -> list[UplinkEntry]:
        entries = [UplinkEntry(*e) for i in self.order
                   for e in protocol.unpack_agg_entries(frames[i].payload)]
        entries.sort(key=lambda e: e.client)
        ids = [e.client for e in entries]
        if ids != list(range(self.n_clients)):
            raise ValueError(f"AGG entries cover clients {ids}, expected 0..{self.n_clients - 1}")
        return entries

    def init_handshake(self) -> None:
        self._subtree_handshake()
        self._broadcast(Frame(type=MsgType.INIT, payload=protocol.pack_vector(self.x)))
        frames = self._collect(MsgType.AGG)
        if self.combine == "exact":
            entries = self._entries_from_aggs(frames)
            # the flat star's init aggregation, op for op
            h = upload_vector(np.stack([protocol.unpack_vector(e.payload) for e in entries]),
                              self.device)
            for row, e in enumerate(entries):
                self._on_init_ack(e.client, h[row])
            self.h_global = torch.mean(h, dim=0)
            return
        count = 0
        h_sums = []
        for i in self.order:
            sub_count, sub_h = protocol.unpack_agg_hsum(frames[i].payload)
            count += sub_count
            h_sums.append(sub_h)
        if count != self.n_clients:
            raise ValueError(f"AGG hsums cover {count} leaves, expected {self.n_clients}")
        self.h_global = torch.sum(upload_vector(np.stack(h_sums), self.device), dim=0) / self.n_clients

    def _gather_uplinks(self, r: int) -> list[UplinkEntry]:
        return self._entries_from_aggs(self._collect(MsgType.AGG))

    def step_round(self, r: int) -> dict:
        if self.combine == "exact":
            return super().step_round(r)
        x_host = self.x.cpu().numpy()
        self._broadcast(Frame(type=MsgType.ROUND, round=r, payload=protocol.pack_vector(x_host)))
        self.x_hist.append(x_host)
        frames = self._collect(MsgType.AGG)
        count = abits = pbits = fbytes = 0
        grad_sums, s_sums, l_sums, f_sums = [], [], [], []
        for i in self.order:
            sub_n, sub_a, sub_p, sub_f, sub_l, sub_fv, sub_grad, sub_s = (
                protocol.unpack_agg_roundsum(frames[i].payload))
            count += sub_n
            abits += sub_a
            pbits += sub_p
            fbytes += sub_f
            l_sums.append(sub_l)
            f_sums.append(sub_fv)
            grad_sums.append(sub_grad)
            s_sums.append(sub_s)
        n = self.n_clients
        if count != n:
            raise ValueError(f"AGG sums cover {count} leaves, expected {n}")
        grad = torch.sum(upload_vector(np.stack(grad_sums), self.device), dim=0) / n
        s = torch.sum(upload_vector(np.stack(s_sums), self.device), dim=0) / n
        lf = torch.sum(upload_vector(np.stack([l_sums, f_sums]), self.device), dim=1) / n
        x_new = master_step(self.x, self.h_global, grad, lf[0], self.cfg)
        self.h_global = self.h_global + self.alpha * s
        self.x = x_new
        grad_norm, f = torch.stack([torch.linalg.vector_norm(grad), lf[1]]).tolist()
        return {
            "grad_norm": grad_norm,
            "f": f,
            "sent_bits": abits,
            "measured_payload_bits": pbits,
            "measured_frame_bytes": fbytes,
        }


# ---------------------------------------------------------------------------
# AsyncStarMaster: bounded-staleness aggregation
# ---------------------------------------------------------------------------


class AsyncStarMaster(StarMaster):
    """A flat star without the barrier: each commit folds in what arrived.

    Per commit r every idle client is assigned the current iterate (one
    ROUND frame); an assignment made at round a becomes *visible* at round
    ``a + min(delay(a, i), staleness)``, the delay drawn from the spec's
    arrival schedule (a client's first assignment is visible at once: the
    fleet starts synchronized).  The commit averages the latest gradients of
    ALL clients (stale ones included) and folds the freshly arrived
    corrections into H (an absent client's S_i is 0: the master keeps its
    H_i).  At staleness=0 every client is fresh every round and the ops are
    StarMaster's round's.

    The schedule is a function of (schedule_seed, round, client), the master
    makes its transport calls in (round, client-id) order, and a client
    advances its key spine once per ROUND received, so replaying the
    broadcast history rebuilds every table bit for bit: what restore rides on.
    """

    def __init__(
        self,
        conns: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        topology: TopologySpec,
        x0=None,
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(conns, d, cfg, x0=x0, drive=drive, device=device)
        self.staleness = topology.staleness
        self.max_delay = topology.max_delay
        self.schedule_seed = topology.schedule_seed
        # in-flight assignments: client -> (assigned round, visible round)
        self._inflight: dict[int, tuple[int, int]] = {}
        # the last visible assignment round of each client (-1: none yet)
        self._last: dict[int, int] = {cid: -1 for cid in self.order}
        self._grad_tab: dict[int, np.ndarray] = {}
        self._l_tab: dict[int, float] = {}
        self._f_tab: dict[int, float] = {}

    def _delay(self, cid: int, r: int) -> int:
        if self.staleness == 0 or self.max_delay == 0:
            return 0
        rng = np.random.default_rng((self.schedule_seed, r, cid))
        return int(rng.integers(0, self.max_delay + 1))

    def _exec_round(self, r: int, x_bcast: np.ndarray, commit: bool):
        # assign the idle clients, in client-id order (a first assignment lands now)
        for cid in self.order:
            if cid not in self._inflight:
                send_frame(self.conns[cid], Frame(type=MsgType.ROUND, round=r,
                                                  payload=protocol.pack_vector(x_bcast)))
                lag = 0 if self._last[cid] < 0 else min(self._delay(cid, r), self.staleness)
                self._inflight[cid] = (r, r + lag)
        if self.drive is not None:
            self.drive()
        self.x_hist.append(x_bcast)

        # the deliveries visible at this commit, in client-id order
        arrived = sorted(cid for cid, (_, due) in self._inflight.items() if due <= r)
        s_new: dict[int, torch.Tensor] = {}
        pbits = abits = fbytes = 0
        for cid in arrived:
            a, _ = self._inflight.pop(cid)
            fr = recv_frame(self.conns[cid])
            if fr.type != MsgType.UPLINK or fr.client != cid:
                raise ValueError(
                    f"async master expected UPLINK from {cid}, got {fr.type} from {fr.client}"
                )
            grad_i, l_i, f_i, hess_bytes = protocol.unpack_uplink(fr.payload, self.d)
            s_i = self.codec.decode(hess_bytes, fr.sent_elems)
            self._on_decoded(cid, s_i)
            self._grad_tab[cid] = grad_i
            self._l_tab[cid] = l_i
            self._f_tab[cid] = f_i
            self._last[cid] = a
            s_new[cid] = s_i
            pbits += fr.payload_bits
            abits += wire.payload_bits(self.comp, fr.sent_elems)
            fbytes += fr.wire_bytes

        if not commit:
            return None
        zero_s = torch.zeros(triu_size(self.d), dtype=torch.float64, device=self.device)
        # at staleness=0 these are StarMaster's aggregation ops verbatim
        grads, l_c, f_c = (
            upload_vector(np.stack([tab[cid] for cid in self.order]), self.device)
            for tab in (self._grad_tab, self._l_tab, self._f_tab))
        s_full = [s_new.get(cid, zero_s) for cid in self.order]
        grad = torch.mean(grads, dim=0)
        s = torch.mean(torch.stack(s_full), dim=0)
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
            "participants": tuple(arrived),
        }

    def step_round(self, r: int) -> dict:
        return self._exec_round(r, self.x.cpu().numpy(), commit=True)

    def replay_round(self, r: int, x_bcast: np.ndarray) -> None:
        """Re-run the assignment and delivery bookkeeping under the recorded
        broadcast (the tables, the in-flight set and the clients' key spines
        advance as in the original run); the commit is skipped, since x and
        H come from the checkpoint."""
        self._exec_round(r, np.asarray(x_bcast, dtype=np.float64), commit=False)


# ---------------------------------------------------------------------------
# ElasticStarMaster: join/leave membership
# ---------------------------------------------------------------------------


class ElasticStarMaster(StarMaster):
    """A flat synchronous star over a cohort that changes by round.

    The master mirrors each active client's H_i (seeded by its INIT_ACK and
    advanced by the ``+ alpha * S_i`` the client applies: the mirror is the
    client's state bit for bit).  Events apply at the start of their round:
    ``leave`` sends the client STOP, drops it from the cohort and RECOMPUTES
    H_global as the mean of a fresh stack of the remaining mirrors (exact
    retirement, no subtraction); ``join`` sends a late INIT at the current
    iterate (the client builds H_i there, per ``hess0``), mirrors it, and
    counts its T*64-bit INIT_ACK into the round's uplink exactly.
    """

    def __init__(
        self,
        conns: dict[int, Connection],
        d: int,
        cfg: FedNLConfig,
        membership: MembershipSpec,
        n_clients: int,
        x0=None,
        drive: Callable[[], None] | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(conns, d, cfg, x0=x0, drive=drive, device=device)
        if sorted(conns) != list(range(n_clients)):
            raise ValueError(
                "elastic membership needs a connection per client id "
                f"0..{n_clients - 1} (idle joiners stay connected), got {sorted(conns)}"
            )
        self.membership = membership
        self.n_clients = n_clients
        self._mirrors: dict[int, torch.Tensor] = {}
        self._left: set[int] = set()
        # the base broadcast, collect and aggregate iterate self.order: point
        # it at the active cohort, which the events change in place
        self.order = membership.initial_active(n_clients)

    def _on_init_ack(self, cid: int, h_i: torch.Tensor) -> None:
        self._mirrors[cid] = h_i

    def _on_decoded(self, cid: int, s_i: torch.Tensor) -> None:
        # the client's own H_i update, op for op (StarClient._handle_round)
        self._mirrors[cid] = self._mirrors[cid] + self.alpha * s_i

    def _recompute_invariant(self) -> None:
        self.h_global = torch.mean(torch.stack([self._mirrors[c] for c in self.order]), dim=0)

    def _apply_events(self, r: int, x_bcast) -> dict:
        joined, left = [], []
        join_pbits = join_fbytes = 0
        for ev in self.membership.events_at(r):
            if ev.action == "leave":
                if ev.client not in self.order:
                    raise ValueError(f"round {r}: client {ev.client} cannot leave — not active")
                send_frame(self.conns[ev.client], Frame(type=MsgType.STOP))
                if self.drive is not None:
                    self.drive()
                self.order.remove(ev.client)
                self._left.add(ev.client)
                del self._mirrors[ev.client]
                if not self.order:
                    raise ValueError(f"round {r}: membership schedule empties the cohort")
                self._recompute_invariant()
                left.append(ev.client)
            else:  # join
                if ev.client in self.order or ev.client in self._left:
                    raise ValueError(
                        f"round {r}: client {ev.client} cannot join — "
                        "already active or already departed"
                    )
                send_frame(self.conns[ev.client], Frame(type=MsgType.INIT,
                                                        payload=protocol.pack_vector(x_bcast)))
                if self.drive is not None:
                    self.drive()
                ack = recv_frame(self.conns[ev.client])
                if ack.type != MsgType.INIT_ACK or ack.client != ev.client:
                    raise ValueError(
                        f"expected INIT_ACK from joining client {ev.client}, got "
                        f"{ack.type} from {ack.client}"
                    )
                self._on_init_ack(ev.client, upload_vector(protocol.unpack_vector(ack.payload),
                                                           self.device))
                bisect.insort(self.order, ev.client)
                self._recompute_invariant()
                # the joined client's uplink, counted exactly: T FP64 state
                # bits (payload = analytic) and the framed ack's bytes
                join_pbits += 8 * len(ack.payload)
                join_fbytes += ack.wire_bytes
                joined.append(ev.client)
        return {"joined": joined, "left": left, "pbits": join_pbits, "fbytes": join_fbytes}

    def step_round(self, r: int) -> dict:
        ev = self._apply_events(r, self.x)
        m = super().step_round(r)
        m["sent_bits"] += ev["pbits"]  # T*64 state bits per join, exact
        m["measured_payload_bits"] += ev["pbits"]
        m["measured_frame_bytes"] += ev["fbytes"]
        m["participants"] = tuple(self.order)
        return m

    def replay_round(self, r: int, x_bcast: np.ndarray) -> None:
        """Replay the cohort history and the mirrors' updates: the events
        re-apply (STOP and late-INIT traffic included) and the round's
        uplinks are decoded only to advance the mirrors; x and H come from
        the checkpoint."""
        x_bcast = np.asarray(x_bcast, dtype=np.float64)
        self._apply_events(r, x_bcast)
        self._broadcast(Frame(type=MsgType.ROUND, round=r, payload=protocol.pack_vector(x_bcast)))
        self.x_hist.append(x_bcast)
        self._decode_entries(self._gather_uplinks(r))

    def stop(self) -> None:
        """STOP every client still connected, active or never joined (a
        broadcast to the cohort would leave idle joiners on a blocking recv)."""
        if not self._stopped:
            self._stopped = True
            for cid in sorted(self.conns):
                if cid not in self._left:
                    send_frame(self.conns[cid], Frame(type=MsgType.STOP))
            if self.drive is not None:
                self.drive()


# ---------------------------------------------------------------------------
# construction seams
# ---------------------------------------------------------------------------


def make_master(
    conns: dict[int, Connection],
    d: int,
    cfg: FedNLConfig,
    topology: TopologySpec | None = None,
    membership: MembershipSpec | None = None,
    n_clients: int | None = None,
    x0=None,
    drive: Callable[[], None] | None = None,
    device: str | torch.device | None = None,
) -> StarMaster:
    """The master factory: spec -> StarMaster | TreeMaster | AsyncStarMaster
    | ElasticStarMaster.  ``conns`` lead to clients for the star kinds and
    to the root's aggregators for a tree; ``n_clients`` is the leaf count
    (needed where it differs from ``len(conns)``)."""
    n = len(conns) if n_clients is None else n_clients
    if membership is not None and not membership.trivial:
        if topology is not None and not topology.trivial:
            raise ValueError("membership events compose with the flat sync star only")
        return ElasticStarMaster(conns, d, cfg, membership, n_clients=n, x0=x0, drive=drive,
                                 device=device)
    if topology is not None and topology.kind == "tree":
        return TreeMaster(conns, d, cfg, topology, n_clients=n, x0=x0, drive=drive,
                          device=device)
    if topology is not None and topology.mode == "async":
        return AsyncStarMaster(conns, d, cfg, topology, x0=x0, drive=drive, device=device)
    return StarMaster(conns, d, cfg, x0=x0, drive=drive, device=device)


def _selective_drive(clients: list) -> Callable[[], None]:
    """Drive in-process clients by polling their buffers: only clients with
    frames pending are served, so partial broadcasts (async assignments,
    membership events) cannot deadlock, and a full broadcast serves every
    client once, in the same order as the star's drive."""
    done = [False] * len(clients)

    def drive() -> None:
        for i, c in enumerate(clients):
            while not done[i] and c.conn.pending():
                if not c.serve_once():
                    done[i] = True

    return drive


def _device_z(z, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(z, dtype=torch.float64).to(device)


def make_selective_loopback_clients(
    z, cfg: FedNLConfig, seed: int = 0, device: str | torch.device | None = None
) -> tuple[dict[int, Connection], Callable[[], None]]:
    """In-process client fleet with the selective drive: the wiring of the
    async and elastic masters, whose broadcasts are partial."""
    device = resolve_device(device)
    z = _device_z(z, device)
    n_clients = z.shape[0]
    master_conns: dict[int, Connection] = {}
    clients: list[StarClient] = []
    for i in range(n_clients):
        a, b = loopback_pair()
        master_conns[i] = a
        clients.append(StarClient(i, n_clients, z[i], cfg, b, seed=seed, device=device))
    return master_conns, _selective_drive(clients)


def _wire_subtree(
    node_id: int,
    subtree: tuple,
    z: torch.Tensor,
    cfg: FedNLConfig,
    combine: str,
    seed: int,
    device: torch.device,
) -> tuple[Connection, AggregatorNode]:
    """Build one in-process subtree, recursively: returns the parent-side
    connection and the aggregator (its children's drive hangs off it)."""
    n_clients, _, d = z.shape
    children: dict[int, Connection] = {}
    agg_children: set[int] = set()
    leaf_clients: list[StarClient] = []
    sub_drives: list[Callable[[], None]] = []
    for pos, node in enumerate(subtree):
        if isinstance(node, (tuple, list)):
            parent_side, sub_agg = _wire_subtree(pos, tuple(node), z, cfg, combine, seed, device)
            children[pos] = parent_side
            agg_children.add(pos)
            sub_drives.append(_agg_drive(parent_side, sub_agg))
        else:
            cid = int(node)
            a, b = loopback_pair()
            children[cid] = a
            leaf_clients.append(StarClient(cid, n_clients, z[cid], cfg, b, seed=seed,
                                           device=device))
    leaf_drive = _selective_drive(leaf_clients)

    def drive() -> None:
        leaf_drive()
        for sub in sub_drives:
            sub()

    parent_a, parent_b = loopback_pair()
    node = AggregatorNode(node_id, parent_b, children, d, cfg, combine=combine,
                          agg_children=agg_children, drive=drive, device=device)
    return parent_a, node


def _agg_drive(parent_side: Connection, node: AggregatorNode) -> Callable[[], None]:
    """Serve an in-process aggregator whenever its parent-side buffer holds
    frames (each serve_once takes one parent frame end to end)."""
    done = [False]

    def drive() -> None:
        while not done[0] and node.parent.pending():
            if not node.serve_once():
                done[0] = True

    return drive


def make_loopback_tree(
    z,
    cfg: FedNLConfig,
    topology: TopologySpec,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[dict[int, Connection], Callable[[], None]]:
    """In-process tree of stars: one AggregatorNode per subtree, loopback
    buffers everywhere; returns the root's connections (keyed by subtree
    index) and the drive.  z goes to the device once."""
    device = resolve_device(device)
    z = _device_z(z, device)
    shape = topology.resolve(z.shape[0])
    conns: dict[int, Connection] = {}
    drives: list[Callable[[], None]] = []
    for i, subtree in enumerate(shape):
        parent_side, agg = _wire_subtree(i, subtree, z, cfg, topology.combine, seed, device)
        conns[i] = parent_side
        drives.append(_agg_drive(parent_side, agg))

    def drive() -> None:
        for sub in drives:
            sub()

    return conns, drive


def open_loopback_master(
    z,
    cfg: FedNLConfig,
    topology: TopologySpec | None = None,
    membership: MembershipSpec | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> StarMaster:
    """Wire an in-process fleet for (topology, membership) and return its
    master, drive attached: the loopback construction seam of the session
    backend."""
    device = resolve_device(device)
    n_clients, _, d = z.shape
    if topology is not None and topology.kind == "tree":
        if membership is not None and not membership.trivial:
            raise ValueError("membership events compose with the flat sync star only")
        conns, drive = make_loopback_tree(z, cfg, topology, seed=seed, device=device)
        return make_master(conns, d, cfg, topology=topology, n_clients=n_clients, drive=drive,
                           device=device)
    needs_selective = ((membership is not None and not membership.trivial)
                       or (topology is not None and topology.mode == "async"))
    if needs_selective:
        conns, drive = make_selective_loopback_clients(z, cfg, seed=seed, device=device)
    else:
        # the flat star's wiring, untouched: a plain star keeps its drive
        conns, drive = make_loopback_clients(z, cfg, seed=seed, device=device)
    return make_master(conns, d, cfg, topology=topology, membership=membership,
                       n_clients=n_clients, drive=drive, device=device)
