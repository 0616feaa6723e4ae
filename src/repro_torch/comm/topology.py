"""The master construction seams of the star (port of the flat-star part of
``repro.comm.topology``).

``make_master`` and ``open_loopback_master`` build the flat synchronous star
for ``topology=None`` (or a trivial spec: the flat sync star) and no
membership events.  A tree of stars, asynchronous aggregation and elastic
membership, with their aggregator nodes and AGG / SUBTREE frames, are not
ported (ROADMAP A11, topology): a spec that asks for one raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.comm.star import StarMaster, make_loopback_clients
from repro_torch.comm.transport import Connection
from repro_torch.core.fednl import FedNLConfig


def _live(part) -> bool:
    """A topology or membership spec that changes the run (not None, not trivial)."""
    return part is not None and not getattr(part, "trivial", False)


def check_flat_star(topology=None, membership=None) -> None:
    """Raise unless (topology, membership) is the flat synchronous star."""
    if _live(topology) or _live(membership):
        what = "topology" if _live(topology) else "membership"
        raise NotImplementedError(
            f"a non-trivial {what} spec (a tree of stars, asynchronous aggregation "
            "or membership events) is not ported (ROADMAP A11 (topology)); the flat "
            "synchronous star is"
        )


def make_master(
    conns: dict[int, Connection],
    d: int,
    cfg: FedNLConfig,
    topology=None,
    membership=None,
    n_clients: int | None = None,
    x0=None,
    drive: Callable[[], None] | None = None,
    device: str | torch.device | None = None,
) -> StarMaster:
    """The master factory: the flat star's :class:`StarMaster`."""
    check_flat_star(topology, membership)
    if n_clients is not None and n_clients != len(conns):
        raise ValueError(f"a flat star has one connection per client: {len(conns)} != {n_clients}")
    return StarMaster(conns, d, cfg, x0=x0, drive=drive, device=device)


def open_loopback_master(
    z,
    cfg: FedNLConfig,
    topology=None,
    membership=None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> StarMaster:
    """An in-process client fleet and its master, drive attached: the
    loopback construction seam of the session backend."""
    check_flat_star(topology, membership)
    n_clients, _, d = z.shape
    conns, drive = make_loopback_clients(z, cfg, seed=seed, device=device)
    return make_master(conns, d, cfg, topology=topology, membership=membership,
                       n_clients=n_clients, drive=drive, device=device)
