"""Multi-pod dry run of the port (port of ``repro.launch.dryrun``): every
(architecture x input shape x mesh) step runs on the production mesh, and
each rank's flops, bytes and collective bytes are counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
    ... --json out.json   (machine-readable roofline terms per combination)
    ... --workers 6       (a mesh's archs spread over 6 fake worlds)
    ... --fednl           (the sharded FedNL round on both meshes)

Where the reference compiles each step for 256 or 512 placeholder XLA
devices, the port runs it on the CPU: the arguments are meta DTensors
(shapes, no storage) laid out by the spec trees on a ``DeviceMesh`` over a
fake process group of the mesh's ranks (``launch.mesh.fake_world``: its
collectives move nothing), with the activations pinned by
``layers.constrain``.  This process is rank 0, and counts rank 0's work
(``roofline.step_cost`` on DTensors): the ops on its local shards and the
collectives DTensor issues.  A process holds one default group, so each
mesh is counted in a spawned process of its own (:func:`in_fake_world`);
the caller's process never joins a fake group.

A record's status is ``ok`` when the production step ran on the mesh to
its end and each output's placements are its out spec's (the step's
outputs are laid out by the out specs as ``jax.jit``'s out_shardings lay
them out, the collectives counted).  ``memory_analysis`` is per rank: the
arguments' and outputs' local bytes, and ``temp_bytes``, the most storage
the step's ops held at once; ``meta_step_s`` is the seconds of the meta
step (where the reference has its compile's).  The roofline terms come
from the reference's probes (:func:`probe_roofline`), priced on
``roofline.H100_SXM``: its collective term at NVLink's rate, a lower bound
where a 16-wide axis spans two 8-card NVLink domains.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import sys
import time
import traceback

import torch

from repro_torch import roofline as rl
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import (
    data_axes,
    fake_world,
    make_production_mesh,
    mesh_axis_sizes,
    production_axis_sizes,
)
from repro_torch.launch.specs import SHAPES, build_dryrun, param_abstract_and_shardings
from repro_torch.models.layers import is_dtensor, set_sharding_axes

MACHINE = rl.H100_SXM


def _register_mesh_axes(mesh) -> None:
    set_sharding_axes(data_axes(mesh.mesh_dim_names), "model", mesh_axis_sizes(mesh))


def _leaves(tree) -> list:
    """The leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [x for val in tree.values() for x in _leaves(val)]
    if isinstance(tree, (tuple, list)):
        return [x for val in tree for x in _leaves(val)]
    return [tree]


def _lay_out(out, placements):
    """The step's outputs redistributed to their out placements (a tree of
    the outputs' nesting whose leaves are placement tuples)."""
    if isinstance(out, dict):
        return {key: _lay_out(val, placements[key]) for key, val in out.items()}
    if isinstance(out, (tuple, list)) and not _is_placements(placements):
        return type(out)(_lay_out(val, pl) for val, pl in zip(out, placements))
    if is_dtensor(out) and tuple(out.placements) != tuple(placements):
        return out.redistribute(out.device_mesh, tuple(placements))
    return out


def _is_placements(tree) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(tree, tuple) and all(isinstance(p, Placement) for p in tree)


def _misplaced(out, placements, path: str = "") -> list[str]:
    """The outputs that are not DTensors of their out placements."""
    if isinstance(out, dict):
        return [m for key in out for m in _misplaced(out[key], placements[key], f"{path}/{key}")]
    if isinstance(out, (tuple, list)) and not _is_placements(placements):
        return [m for i, (val, pl) in enumerate(zip(out, placements))
                for m in _misplaced(val, pl, f"{path}/{i}")]
    if isinstance(out, int):  # a cache's position
        return []
    if not is_dtensor(out):
        return [f"{path}: not on the mesh"]
    if tuple(out.placements) != tuple(placements):
        return [f"{path}: {tuple(out.placements)} != {tuple(placements)}"]
    return []


def _with_out_layout(spec):
    """``spec.step_fn`` whose outputs are laid out by ``spec.out_shardings``."""
    def step(*args):
        return _lay_out(spec.step_fn(*args), spec.out_shardings)

    return step


def _local_bytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if is_dtensor(leaf) else leaf
            total += local.numel() * local.element_size()
    return total


def _measure(cfg, shape_name, mesh, batch_override=None) -> dict:
    """Rank 0's (flops, hbm bytes, collective bytes by kind) of one step."""
    spec = build_dryrun(cfg, shape_name, mesh, batch_override=batch_override)
    cost = rl.step_cost(_with_out_layout(spec), *spec.args)
    return {"flops": cost.flops, "hbm_bytes": cost.bytes,
            **{f"coll:{k}": float(v) for k, v in cost.coll.items()}}


def probe_roofline(cfg, shape_name: str, mesh) -> dict:
    """FLOPs/bytes/collectives of the FULL config via small probes.

    The reference's extrapolation: every cost metric is linear in (L, A*L,
    A) where L is the layer count and A the accumulation steps, cost = a +
    b*L + c*A + d*A*L; four probes at depths 2 and 4 patterns (two for
    inference shapes, where A = 1) identify the coefficients.  The port
    counts every loop iteration, so a direct count at the full depth is
    the same number (the tests hold the two equal at a reduced config);
    the probes only cost less.
    """
    shape = SHAPES[shape_name]
    pat = len(cfg.hybrid.pattern) if cfg.hybrid else 1
    l1, l2 = 2 * pat, 4 * pat

    def shrink(layers, accum):
        kw = dict(n_layers=layers, accum_steps=accum, unroll_layers=True)
        if cfg.encoder_layers:
            kw["encoder_layers"] = layers
        # full attention does the same work for any q_chunk (every chunk
        # attends all keys), so probes use larger chunks; windowed
        # attention's work depends on q_chunk, so it keeps its own
        if cfg.window is None and cfg.family != "hybrid":
            kw["q_chunk"] = 4096
        return dataclasses.replace(cfg, **kw)

    sizes = mesh_axis_sizes(mesh)
    dp_size = 1
    for ax, size in sizes.items():
        if ax in ("pod", "data"):
            dp_size *= size

    if shape.kind == "train":
        a_full = max(1, min(cfg.accum_steps, shape.batch // dp_size))
        micro = shape.batch // a_full
        p1 = _measure(shrink(l1, 1), shape_name, mesh, batch_override=micro)
        p2 = _measure(shrink(l2, 1), shape_name, mesh, batch_override=micro)
        p3 = _measure(shrink(l1, 2), shape_name, mesh, batch_override=2 * micro)
        p4 = _measure(shrink(l2, 2), shape_name, mesh, batch_override=2 * micro)
        out = {}
        for k in p1:
            d = ((p4[k] - p3[k]) - (p2[k] - p1[k])) / (l2 - l1)
            b = (p2[k] - p1[k]) / (l2 - l1) - d
            c = p3[k] - p1[k] - d * l1
            a = p1[k] - b * l1 - c - d * l1
            out[k] = max(0.0, a + b * cfg.n_layers + c * a_full + d * a_full * cfg.n_layers)
        return out
    p1 = _measure(shrink(l1, 1), shape_name, mesh)
    p2 = _measure(shrink(l2, 1), shape_name, mesh)
    out = {}
    for k in p1:
        slope = (p2[k] - p1[k]) / (l2 - l1)
        out[k] = max(0.0, p1[k] + slope * (cfg.n_layers - l1))
    return out


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def _terms(flops: float, hbm: float, coll_total: float) -> dict:
    terms = {"compute": flops / MACHINE.peak_flops, "memory": hbm / MACHINE.hbm_bw,
             "collective": coll_total / MACHINE.ici_bw}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"], "dominant": max(terms, key=terms.get)}


def run_one(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
            roofline_probes: bool = True, overrides: dict | None = None) -> dict:
    """One (arch x shape x mesh) record.  Runs in a process whose default
    group is the mesh's fake world (:func:`in_fake_world`)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    rec: dict = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
    }
    _register_mesh_axes(mesh)
    spec = build_dryrun(cfg, shape_name, mesh)
    if spec.skip:
        rec["status"] = "skip"
        rec["reason"] = spec.skip
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {spec.skip}")
        return rec

    t0 = time.perf_counter()
    try:
        # 1) the production step on the mesh, to its end: the dry run's
        #    proof, and its per-rank memory
        held = {}

        def step(*args):
            held["out"] = out = _with_out_layout(spec)(*args)
            return out

        cost = rl.step_cost(step, *spec.args)
        t_step = time.perf_counter() - t0
        out = held.pop("out")
        wrong = _misplaced(out, spec.out_shardings)
        if wrong:
            raise RuntimeError("outputs off their out specs: " + "; ".join(wrong[:4]))

        shape = SHAPES[shape_name]
        params_abs, _ = param_abstract_and_shardings(cfg, production_axis_sizes(
            multi_pod=multi_pod))
        tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
        mf = rl.model_flops_global(cfg, params_abs, tokens=tokens, kind=shape.kind)

        rec.update(
            status="ok",
            note=spec.note,
            meta_step_s=round(t_step, 2),
            n_params=rl.count_params(params_abs),
            n_params_active=rl.active_params(cfg, params_abs),
            memory_analysis={
                "argument_bytes": _local_bytes(spec.args),
                "output_bytes": _local_bytes(out),
                "temp_bytes": cost.peak_bytes,
            },
        )
        if verbose:
            print(f"[ok] {arch} x {shape_name} ({rec['mesh']}): meta step {t_step:.1f}s")
            print(f"     memory_analysis (per rank): {rec['memory_analysis']}")

        # 2) roofline terms from the probes (single-pod table)
        if roofline_probes:
            est = probe_roofline(cfg, shape_name, mesh)
            coll = {k[5:]: v for k, v in est.items() if k.startswith("coll:")}
            coll_total = sum(coll.values())
            rec["roofline"] = {
                "flops": est["flops"],
                "hbm_bytes": est["hbm_bytes"],
                "coll_bytes": coll_total,
                **_terms(est["flops"], est["hbm_bytes"], coll_total),
                "model_flops": mf / chips,
                "useful_fraction": (mf / chips) / est["flops"] if est["flops"] else None,
            }
            rec["collectives"] = coll
            if verbose:
                r = rec["roofline"]
                print(f"     cost (probe-extrapolated, per rank): flops={est['flops']:.3e} "
                      f"hbm={est['hbm_bytes']:.3e} coll={coll_total:.3e}")
                print(f"     roofline: compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                      f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
                      f"useful={r['useful_fraction']:.3f}")
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch} x {shape_name}: {rec['error']}")
            traceback.print_exc()
    return rec


def fednl_closed_form(name: str, n_clients: int, d: int, k: int) -> dict[str, int]:
    """Per-rank collective bytes of one sharded FedNL round, from
    ``distributed/fednl_shard.py``'s messages: dense_psum all-reduces T + d
    + 2 f64 and 3 i64; sparse_allgather all-gathers every client's k int32
    indices and k values (f64, or f32) and all-reduces d + 2 f64 and 3
    i64."""
    from repro_torch.linalg import triu_size

    t = triu_size(d)
    counts = 3 * 8
    if name == "dense_psum":
        return {"all-reduce": (t + d + 2) * 8 + counts, "all-gather": 0}
    val = 4 if name == "sparse_allgather_f32" else 8
    return {"all-reduce": (d + 2) * 8 + counts, "all-gather": n_clients * k * (4 + val)}


def run_fednl_dryrun(multi_pod: bool = False) -> list[dict]:
    """The paper's own technique on the production mesh: the sharded FedNL
    round (clients on the data axis, ``make_sharded_fednl_step`` over its
    group) counted per rank for each aggregation.  W8A's dimensions scaled
    to one pod: d = 301, n_i = 348, 16 clients a data shard.  Runs in the
    mesh's fake world."""
    from repro_torch.core.fednl import FedNLConfig
    from repro_torch.distributed.fednl_shard import make_sharded_fednl_step
    from repro_torch.linalg import triu_size

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    d, n_i = 301, 348
    n_data = mesh_axis_sizes(mesh)["data"]
    n_clients = 16 * n_data  # 16 clients per data shard
    n_loc = n_clients // n_data
    t = triu_size(d)
    cfg = FedNLConfig(compressor="topk", k_multiplier=8.0, lam=1e-3)

    def meta(*shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device="meta")

    records = []
    variants = [
        ("dense_psum", None),
        ("sparse_allgather", None),
        ("sparse_allgather_f32", torch.float32),
    ]
    for name, payload in variants:
        agg = "dense_psum" if name == "dense_psum" else "sparse_allgather"
        rec = {"arch": f"fednl/{name}", "shape": "w8a_round",
               "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips}
        try:
            step = make_sharded_fednl_step(n_clients, d, cfg, mesh.get_group("data"), agg,
                                           payload_dtype=payload)
            cost = rl.step_cost(step, meta(n_loc, n_i, d), meta(n_loc, t), meta(d), meta(t),
                                meta(2, dtype=torch.uint32))
            coll_total = float(sum(cost.coll.values()))
            rec.update(
                status="ok",
                roofline={"flops": cost.flops, "hbm_bytes": cost.bytes, "coll_bytes": coll_total,
                          **_terms(cost.flops, cost.bytes, coll_total)},
                collectives=dict(cost.coll),
                closed_form=fednl_closed_form(name, n_clients, d, cfg.k_for(d)),
            )
            print(f"[ok] fednl/{name} ({rec['mesh']}): flops={cost.flops:.3e} "
                  f"hbm={cost.bytes:.3e} coll={coll_total:.3e} "
                  f"dom={rec['roofline']['dominant']}")
        except Exception as e:  # noqa: BLE001
            rec.update(status="fail", error=f"{type(e).__name__}: {e}")
            print(f"[FAIL] fednl/{name}: {rec['error']}")
            traceback.print_exc()
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# a mesh's fake world, in a process of its own
# ---------------------------------------------------------------------------

def _world_main(multi_pod: bool, conn) -> None:
    """A fake world's process: join the world, then run the calls that
    come down ``conn`` until None."""
    try:
        torch.set_num_threads(1)
        with fake_world(512 if multi_pod else 256):
            conn.send(("ok", None))
            while (job := conn.recv()) is not None:
                fn, args = job
                try:
                    conn.send(("ok", fn(*args)))
                except Exception:  # noqa: BLE001 -- the caller re-raises it
                    conn.send(("error", traceback.format_exc()))
    except BaseException:  # noqa: BLE001
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class FakeWorld:
    """A spawned process that is rank 0 of the production mesh's fake
    world (256 ranks, or 512 when ``multi_pod``), running calls:
    ``call(fn, *args)`` returns ``fn(*args)`` run there (``fn`` importable:
    a module's function).  ``close()``, or the end of a ``with``, stops
    it."""

    def __init__(self, multi_pod: bool):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_world_main, args=(multi_pod, child), daemon=True)
        self._proc.start()
        child.close()
        self._answer()

    def _answer(self):
        try:
            status, out = self._conn.recv()
        except EOFError:
            self._proc.join()
            raise RuntimeError(f"the fake world's process died (exit code "
                               f"{self._proc.exitcode})") from None
        if status != "ok":
            raise RuntimeError(f"in the fake world: {out}")
        return out

    def call(self, fn, *args):
        self._conn.send((fn, args))
        return self._answer()

    def close(self) -> None:
        if self._proc.is_alive():
            try:
                self._conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        self._proc.join(timeout=60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def in_fake_world(multi_pod: bool, fn, *args):
    """``fn(*args)`` in a fresh :class:`FakeWorld` of the mesh; its result."""
    with FakeWorld(multi_pod) as world:
        return world.call(fn, *args)


def sweep(multi_pod: bool, archs: list[str], shapes: list[str], probes: bool,
          overrides: dict) -> list[dict]:
    """Every arch x shape on one mesh (in its fake world)."""
    records = []
    for arch in archs:
        for shape in shapes:
            records.append(run_one(arch, shape, multi_pod, roofline_probes=probes,
                                   overrides=overrides))
            sys.stdout.flush()
    return records


def sweep_in_worlds(multi_pod: bool, archs: list[str], shapes: list[str], probes: bool,
                    overrides: dict, workers: int) -> list[dict]:
    """:func:`sweep` with its archs spread over ``workers`` fake worlds of
    the mesh, each a process of its own; the records in the archs' order."""
    import threading

    share = [archs[i::workers] for i in range(workers)]
    out: list = [None] * workers

    def run(i):
        try:
            out[i] = in_fake_world(multi_pod, sweep, multi_pod, share[i], shapes, probes,
                                   overrides)
        except Exception as err:  # noqa: BLE001 -- re-raised below
            out[i] = err

    threads = [threading.Thread(target=run, args=(i,)) for i in range(workers) if share[i]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in out:
        if isinstance(res, Exception):
            raise res
    by_arch = {}
    for i, recs in enumerate(out):
        for j, arch in enumerate(share[i]):
            by_arch[arch] = recs[j * len(shapes):(j + 1) * len(shapes)]
    return [rec for arch in archs for rec in by_arch[arch]]


def _write(path: str | None, records: list[dict]) -> None:
    if path:
        with open(path, "w") as fh:
            json.dump(records, fh, indent=2, default=float)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=[*SHAPES, "all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-roofline", action="store_true",
                    help="the mesh proof only, skip the probe extrapolation")
    ap.add_argument("--fednl", action="store_true",
                    help="dry-run the FedNL sharded round itself (both meshes)")
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                    help="ArchConfig override (hillclimb variants), repeatable")
    ap.add_argument("--json", default=None, help="write records to this file")
    ap.add_argument("--workers", type=int, default=1,
                    help="fake worlds a mesh's archs are spread over, each a process")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    if args.fednl:
        records = in_fake_world(False, run_fednl_dryrun, False)
        records += in_fake_world(True, run_fednl_dryrun, True)
        _write(args.json, records)
        n_fail = sum(r["status"] == "fail" for r in records)
        print(f"\nfednl dry-run: {len(records) - n_fail} ok, {n_fail} fail")
        raise SystemExit(1 if n_fail else 0)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for mp in meshes:
        # the roofline table is a single-pod deliverable; the multi-pod
        # pass is the mesh proof only
        probes = (not args.no_roofline) and not mp
        records += sweep_in_worlds(mp, archs, shapes, probes, _parse_overrides(args.set),
                                   max(1, min(args.workers, len(archs))))
        _write(args.json, records)  # checkpointed after each mesh

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    n_fail = sum(r["status"] == "fail" for r in records)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"({time.perf_counter() - t0:.0f} s)")
    if args.json:
        _write(args.json, records)
        print(f"wrote {args.json}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
