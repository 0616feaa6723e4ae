"""Meshes, sharding specs and placements, and the sweep engine's device
plan (port of ``repro.launch.mesh``).

The production meshes of the dry run are named by their axes: 16 x 16
("data", "model") and 2 x 16 x 16 ("pod", "data", "model");
:func:`production_axis_sizes` gives them and :func:`data_axes` the batch
axis.  :class:`P` is the port's sharding spec: per dimension a mesh axis,
a tuple of axes, or None, as ``jax.sharding.PartitionSpec``.
:func:`make_production_mesh` builds either mesh as a ``DeviceMesh`` over
the caller's default process group (the dry run's fake group of 256 or
512 ranks, :func:`fake_world`); :func:`make_mesh` builds a (data, model)
mesh over the visible devices (``launch.train --mesh``).
:func:`placements` turns a ``P`` into a mesh's DTensor placements and
:func:`distribute_tree` lays a tree of tensors out by a tree of specs.

A batched group of S specs spreads over the largest count of devices that
divides S: each device runs the same round on a contiguous shard of the
stacked specs, with no collective.  On the card the devices are the
machine's cards; the CPU is one device.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


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


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """A ``DeviceMesh``'s axis sizes by name."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_production_mesh(*, multi_pod: bool = False):
    """The 16 x 16 ("data", "model") mesh, or 2 x 16 x 16 ("pod", "data",
    "model") when ``multi_pod``, as a ``"cpu"`` ``DeviceMesh`` over the
    caller's default group, which must hold exactly its 256 or 512 ranks."""
    sizes = production_axis_sizes(multi_pod=multi_pod)
    n = math.prod(sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(
            f"the {'x'.join(map(str, sizes.values()))} production mesh needs a default process "
            f"group of {n} ranks; this process's has {world} (repro_torch.launch.mesh.fake_world)")
    return make_mesh(tuple(sizes.values()), tuple(sizes), "cpu")


def make_mesh(dims: tuple[int, ...], axis_names: tuple[str, ...], device_type: str):
    """A ``DeviceMesh`` of shape ``dims`` over the default group's ranks in
    order; the product of ``dims`` must be the group's size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(dims):
        raise ValueError(f"a {'x'.join(map(str, dims))} mesh holds {math.prod(dims)} ranks; "
                         f"the default process group has {world}")
    return init_device_mesh(device_type, tuple(dims), mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake default group of ``world_size``
    ranks (``torch.distributed``'s "fake" backend: collectives move
    nothing), torn down on exit.  For a process of its own: a process
    holds one default group, and a mesh needs one of exactly its size."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run's fake process group needs torch's "
                           "torch.testing._internal.distributed.fake_pg, which this torch "
                           "lacks") from e
    if dist.is_initialized():
        raise RuntimeError(f"this process already has a default group of "
                           f"{dist.get_world_size()} ranks; a fake world needs a process of "
                           "its own")
    import torch.distributed.tensor.placement_types as placement_types

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    cpu_alltoall = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = cpu_alltoall
        dist.destroy_process_group()


def _shard_dim_alltoall(x, gather_dim: int, shard_dim: int, mesh, mesh_dim: int):
    """DTensor's move of a shard from one dimension to another as one
    all-to-all over ``mesh_dim``, as on the card's NCCL: a fake world stands
    for card ranks, and DTensor's path for a "cpu" mesh (gloo has no
    all-to-all) gathers the whole tensor instead."""
    from torch.distributed import _functional_collectives as funcol

    n = mesh.size(mesh_dim)
    parts = torch.stack(torch.chunk(x, n, dim=shard_dim))  # part j goes to rank j
    got = funcol.all_to_all_single(parts, None, None, (mesh, mesh_dim))
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    return torch.cat(got.unbind(0), dim=gather_dim).contiguous()


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` (a :class:`P`) on ``mesh``: a
    dimension whose entry names axes is ``Shard`` on each of them (a tuple
    in the mesh's axis order, the first axis the major one, as a
    ``PartitionSpec``'s); an axis that no entry names is ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} shard one dimension out of the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dimensions")
            out[i] = Shard(dim)
    return out


def distribute(t: torch.Tensor, spec, mesh):
    """``t`` laid out on ``mesh`` by ``spec``: each rank keeps its own shard
    (every rank holds the whole ``t``; nothing is sent).  A meta tensor
    becomes a meta DTensor whose local shard is this rank's shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pl = placements(spec, mesh)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                              run_check=False, shape=t.shape, stride=t.stride())


def distribute_tree(tree, specs, mesh):
    """Each tensor of ``tree`` (nested dicts and tuples) laid out by its
    spec in ``specs`` (the same nesting); other leaves (a cache's int
    position) stay as they are."""
    if isinstance(tree, dict):
        return {key: distribute_tree(val, specs[key], mesh) for key, val in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return tuple(distribute_tree(val, spec, mesh) for val, spec in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return distribute(tree, specs, mesh)
    return tree


def placements_tree(specs, mesh):
    """A tree of specs as a tree of placement tuples on ``mesh``."""
    if isinstance(specs, dict):
        return {key: placements_tree(val, mesh) for key, val in specs.items()}
    if isinstance(specs, P):
        return tuple(placements(specs, mesh))
    return tuple(placements_tree(val, mesh) for val in specs)


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
