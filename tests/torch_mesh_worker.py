"""What the port's mesh tests run in other processes: in a fake world of
the production mesh (``repro_torch.launch.dryrun.FakeWorld``), or as one
rank of a gloo world.  Importable by a spawned process: torch, numpy and
the port only (no test framework, no jax)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def scratch_case(dims: tuple[int, int]) -> tuple[float, dict]:
    """Rank 0's product flops and collective bytes of a (32, 8, 2048)
    activation sharded on batch over data, times a (4096, 2048) weight
    sharded on rows over model, laid out again batch over data, on a
    (data, model) mesh of ``dims`` over the first ranks of the world."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import roofline as rl
    from repro_torch.launch.mesh import P, distribute

    mesh = DeviceMesh("cpu", torch.arange(dims[0] * dims[1]).reshape(dims),
                      mesh_dim_names=("data", "model"))
    x = distribute(torch.empty(32, 8, 2048, device="meta"), P("data"), mesh)
    w = distribute(torch.empty(4096, 2048, device="meta"), P("model"), mesh)
    cost = rl.step_cost(lambda a, b: (a @ b.T).redistribute(mesh, [Shard(0), Replicate()]), x, w)
    return cost.flops, dict(cost.coll)


def one_by_one_step(arch: str, shape: str, batch: int) -> tuple[dict, dict]:
    """A reduced ``arch``'s step at ``shape`` (global batch ``batch``)
    counted on a 1 x 1 mesh (DTensors, the axes registered) and with no
    mesh: (flops, collective bytes) of each."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _register_mesh_axes, _with_out_layout
    from repro_torch.launch.specs import build_dryrun
    from repro_torch.models.layers import clear_sharding_axes

    cfg = dataclasses.replace(get_config(arch).reduced(), q_chunk=4096)
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    _register_mesh_axes(mesh)
    try:
        spec = build_dryrun(cfg, shape, mesh, batch_override=batch)
        on_mesh = rl.step_cost(_with_out_layout(spec), *spec.args)
    finally:
        clear_sharding_axes()
    spec = build_dryrun(cfg, shape, {"data": 1, "model": 1}, batch_override=batch)
    plain = rl.step_cost(spec.step_fn, *spec.args)
    return ({"flops": on_mesh.flops, "coll": dict(on_mesh.coll)},
            {"flops": plain.flops, "coll": dict(plain.coll)})


def probe_and_direct(arch: str, shape: str, n_layers: int, accum: int,
                     q_chunk: int) -> tuple[float, float]:
    """A reduced ``arch`` at ``n_layers``, ``accum_steps`` and ``q_chunk``
    on the 16 x 16 mesh: the probes' extrapolated product flops and a
    direct count's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _measure, _register_mesh_axes, probe_roofline
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers, accum_steps=accum,
                              q_chunk=q_chunk)
    mesh = make_production_mesh()
    _register_mesh_axes(mesh)
    return probe_roofline(cfg, shape, mesh)["flops"], _measure(cfg, shape, mesh)["flops"]


def records(multi_pod: bool, jobs: list[tuple[str, str]], overrides: dict) -> list[dict]:
    """``run_one`` of each (arch, shape), without the probes; each arch's
    ``overrides`` (a dict by arch)."""
    from repro_torch.launch.dryrun import run_one

    return [run_one(arch, shape, multi_pod, verbose=False, roofline_probes=False,
                    overrides=overrides[arch]) for arch, shape in jobs]


def wrong_mesh(multi_pod: bool) -> str:
    """``make_production_mesh``'s refusal of the other mesh's size."""
    from repro_torch.launch.mesh import make_production_mesh

    try:
        make_production_mesh(multi_pod=multi_pod)
    except ValueError as err:
        return str(err)
    return ""


def train_rank(rank: int, world: int, init_file: str, arch: str, params_npz: str, mesh: str,
               wrong_mesh: str, steps: int, batch: int, seq: int, lr: float,
               out_npz: str) -> None:
    """One gloo rank of ``launch.train.train`` on ``mesh`` ("AxB") from the
    params in ``params_npz``, after asking for ``wrong_mesh``; rank 0 saves
    that refusal, the losses and the final params (flat '/' keys) to
    ``out_npz``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.train import mesh_for, train

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cpu = torch.device("cpu")
        try:
            mesh_for(wrong_mesh, cpu)
            refused = ""
        except ValueError as err:
            refused = str(err)
        with np.load(params_npz) as data:
            flat = {k: torch.as_tensor(data[k]) for k in data.files}
        params: dict = {}
        for key, val in flat.items():
            node = params
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = val
        final, losses = train(get_config(arch).reduced(), params, steps=steps, batch=batch,
                              seq=seq, lr=lr, mesh=mesh_for(mesh, cpu), log=lambda _: None)
        if rank == 0:
            out = {f"params/{k}": v.numpy() for k, v in _flat(final).items()}
            np.savez(out_npz, losses=np.asarray(losses), refused=np.array(refused), **out)
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}
