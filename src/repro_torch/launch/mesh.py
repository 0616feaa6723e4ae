"""Mesh axes and the sweep engine's device plan (port of
``repro.launch.mesh``).

The production meshes of the dry run are named by their axes: 16 x 16
("data", "model") and 2 x 16 x 16 ("pod", "data", "model");
:func:`production_axis_sizes` gives them and :func:`data_axes` the batch
axis.  :class:`P` is the port's sharding spec: per dimension a mesh axis,
a tuple of axes, or None, as ``jax.sharding.PartitionSpec``.  The meshes
themselves (``make_production_mesh``, a ``DeviceMesh`` of 256 or 512
ranks) are not built yet (ROADMAP A.4 c).

A batched group of S specs spreads over the largest count of devices that
divides S: each device runs the same round on a contiguous shard of the
stacked specs, with no collective.  On the card the devices are the
machine's cards; the CPU is one device.
"""

from __future__ import annotations

import torch


class P(tuple):
    """A sharding spec: one entry per leading dimension of an array, each a
    mesh axis name, a tuple of names (the dimension split over their
    product) or None (not split); dimensions past the entries are not
    split.  Immutable; ``tuple(spec)`` gives the entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def production_axis_sizes(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes: 16 x 16 = 256 chips a pod; two
    pods when ``multi_pod``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def data_axes(axis_names) -> tuple[str, ...] | str:
    """The batch-sharding axis of a mesh with ``axis_names`` (pod folds into
    data on the multi-pod mesh)."""
    return ("pod", "data") if "pod" in axis_names else "data"


def sweep_devices_available(device: torch.device) -> int:
    """How many devices a group on ``device`` may spread over."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def sweep_mesh_devices(batch_size: int, n_available: int) -> int:
    """The largest device count <= ``n_available`` that divides a batch of
    ``batch_size`` specs (1: the batch stays on one device)."""
    n_dev = n_available
    while n_dev > 1 and batch_size % n_dev:
        n_dev -= 1
    return max(n_dev, 1)


def make_sweep_mesh(n_dev: int, device: torch.device) -> list[torch.device]:
    """The devices of a group's ``n_dev`` shards, in shard order: cards 0 to
    n_dev - 1, or the CPU for each shard."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n_dev)]
    return [device] * n_dev
