"""The sweep engine's device plan (port of the sweep half of
``repro.launch.mesh``).

A batched group of S specs spreads over the largest count of devices that
divides S: each device runs the same round on a contiguous shard of the
stacked specs, with no collective.  On the card the devices are the
machine's cards; the CPU is one device.  The production meshes of the TPU
dry run (``make_production_mesh``, ``data_axes``) are not ported (ROADMAP
A.4).
"""

from __future__ import annotations

import torch


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
