"""Bandwidth/latency cost model of the star topology (port of
``repro.comm.cost``).

The star's communication time is a hub-and-spoke exchange: the master's NIC
is the shared bottleneck for the n uplinks, and every round pays one
broadcast plus one uplink latency.  The model turns wire byte counts (the
codecs' bits, or a star run's measured frames) into seconds.  Defaults
approximate the paper's LAN experiments: 1 Gbit/s links, ~0.2 ms one-way
latency.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCostModel:
    bandwidth_bps: float = 1e9  # per-link, bits/second
    latency_s: float = 2e-4  # one-way message latency
    master_shared_nic: bool = True  # n uplinks serialize through the hub NIC

    def transfer_s(self, bits: float) -> float:
        return self.latency_s + bits / self.bandwidth_bps

    def round_s(self, uplink_bits_total: float, bcast_bits: float, n_clients: int) -> float:
        """One FedNL round: broadcast x, then n client uplinks.

        With a shared master NIC the uplinks serialize on the wire (their
        latencies overlap, the bytes do not); otherwise they are parallel and
        the slowest (== mean, symmetric clients) uplink bounds the round.
        """
        bcast = self.latency_s + bcast_bits / self.bandwidth_bps
        if self.master_shared_nic:
            uplink = self.latency_s + uplink_bits_total / self.bandwidth_bps
        else:
            per_client = uplink_bits_total / max(n_clients, 1)
            uplink = self.latency_s + per_client / self.bandwidth_bps
        return bcast + uplink

    def run_s(self, uplink_bits_per_round, bcast_bits: float, n_clients: int) -> float:
        """Total comm seconds over a recorded per-round uplink-bits history."""
        return sum(self.round_s(float(b), bcast_bits, n_clients) for b in uplink_bits_per_round)


DEFAULT_COST = CommCostModel()
