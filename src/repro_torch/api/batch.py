"""The sweep engine behind ``solve_many`` (port of ``repro.api.batch``).

Plans (batch mode "auto"), by the reference's rules:

  batch   specs on the built-in local backend whose algorithm has a
          ``make_batch_round`` hook, grouped by everything that shapes the
          round except compressor and seed (the data too, under "auto").
          Each group runs its rounds over all its specs at once
          (``repro_torch.core.fednl_batch``): one SYRK launch a round on the
          group's S * n clients, one selection launch per compressor branch,
          one threefry launch per uniform dtype, the master's solves batched.
          A group past the SYRK kernel's grid (65,535 clients) is split, and
          the log says so.  On one card the spec axis is not sharded
          (``devices: 1``).
  warm    local specs that differ only in ``rounds`` share one trajectory
          prefix: one session steps to each round count and reports there,
          bit-identical to per-spec solves (step composability).
  pool    specs on the wire backends (star-loopback, star-tcp) run through
          ``solve()`` on a pool of threads (4 for loopback, 2 for TCP: each
          TCP spec spawns a process per client), one pool per backend.
  seq     everything else (PP, tol early stop, zero rounds, algorithms
          without a batch hook, a lone batchable spec) runs per spec through
          ``solve()``, logged with the reason.

Mode "vmap" batches the oracles' matrix-vector products over the specs and
groups across datasets of one shape, waiving bit identity; mode "never" runs
every spec through ``solve()`` in order.

No fallback: a batched group runs on the device it was given or raises; a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np

from repro_torch.api.registry import Algorithm, get_algorithm, get_backend
from repro_torch.api.report import RunReport, SweepReport

MAX_GROUP_CLIENTS = 65535  # the SYRK kernel's grid (kernels/hessian_syrk.py)

# the wire backends' pools: worker threads per backend
_POOL_WIDTH = {"star-loopback": 4, "star-tcp": 2}


@dataclasses.dataclass
class _Plan:
    kind: str  # "batch" | "warm" | "pool" | "seq"
    indices: list[int]
    reason: str = ""


def _warm_key(spec):
    """Specs identical but for ``rounds`` share one trajectory prefix.
    None = ineligible."""
    from repro_torch.api.backends import LOCAL_BACKEND

    if get_backend(spec.backend) is not LOCAL_BACKEND:
        return None
    if spec.tol > 0.0:
        return None  # early stop can end runs before the shared prefix
    return spec.replace(rounds=0)


def _batch_blockers(spec, algo: Algorithm, backend) -> list[str]:
    """Why this spec cannot join a batched group (empty = it can)."""
    from repro_torch.api.backends import LOCAL_BACKEND

    reasons = []
    if backend is not LOCAL_BACKEND:
        reasons.append(f"backend {spec.backend!r} is not the builtin local simulation")
    if algo.make_batch_round is None:
        reasons.append(f"algorithm {spec.algorithm!r} has no batch-round hook")
    if algo.kind != "full":
        reasons.append("partial participation batches per spec only")
    if spec.tol > 0.0:
        reasons.append("tol early-stop needs a per-round host sync")
    if spec.rounds == 0:
        reasons.append("zero-round run")
    if spec.hessian_impl == "pallas":
        reasons.append("hessian='pallas' runs per spec, as the reference plans it")
    return reasons


def _group_key(spec, alpha: float, vectorize: str, dims: tuple) -> tuple:
    """Everything that shapes the batched round except compressor and seed.
    Under "scan" the data is part of the key (the group shares one z);
    "vmap" batches across datasets of one shape."""
    return (
        spec.algorithm,
        spec.data if vectorize == "scan" else dims,
        spec.rounds,
        spec.objective,
        spec.lam,
        spec.option,
        spec.mu,
        spec.hess0,
        spec.hessian_impl,
        spec.accounting,
        spec.ls_c,
        spec.ls_gamma,
        spec.ls_max_steps,
        spec.ls_tol,
        alpha,
    )


def resolved_alpha(spec, d: int) -> float:
    """The Hessian learning rate the round uses (the compressor's default
    unless the spec overrides it), shared by a group."""
    if spec.compressor.alpha is not None:
        return float(spec.compressor.alpha)
    from repro_torch.compressors import get_compressor
    from repro_torch.linalg import triu_size

    cfg = spec.fednl_config()
    return float(get_compressor(spec.compressor.name, triu_size(d), cfg.k_for(d)).alpha)


def plan_sweep(specs: Sequence, batch_mode: str) -> tuple[list[_Plan], list[str]]:
    """Partition the specs into batched groups, warm-start groups and
    per-spec runs.  Every spec is validated first (``check_spec``), so a bad
    spec fails the whole call with the error ``solve()`` raises."""
    from repro_torch.api.facade import check_spec

    log: list[str] = []
    batch_groups: dict[tuple, list[int]] = {}
    pool_groups: dict[str, list[int]] = {}
    seq: list[tuple[int, str]] = []
    vectorize = "vmap" if batch_mode == "vmap" else "scan"
    dims_cache: dict = {}  # dims() parses LIBSVM files: once per DataSpec

    for i, spec in enumerate(specs):
        algo = get_algorithm(spec.algorithm)
        backend = get_backend(spec.backend)
        check_spec(spec, algo, backend)
        if batch_mode == "never":
            seq.append((i, "batch='never'"))
            continue
        blockers = _batch_blockers(spec, algo, backend)
        if not blockers:
            if spec.data not in dims_cache:
                dims_cache[spec.data] = spec.data.dims()
            dims = dims_cache[spec.data]
            batch_groups.setdefault(
                _group_key(spec, resolved_alpha(spec, dims[0]), vectorize, dims), []
            ).append(i)
        elif spec.backend in _POOL_WIDTH:
            pool_groups.setdefault(spec.backend, []).append(i)
        else:
            seq.append((i, "; ".join(blockers)))

    plans: list[_Plan] = []
    for key, idxs in batch_groups.items():
        if len(idxs) == 1:
            seq.append((idxs[0], "only spec in its batch group"))
            continue
        plans.append(_Plan("batch", idxs, reason=f"group key {key[:3]}..."))
    for backend_name, idxs in pool_groups.items():
        plans.append(_Plan("pool", idxs, reason=backend_name))

    if batch_mode != "never":
        warm_groups: dict = {}
        for i, _ in seq:
            key = _warm_key(specs[i])
            if key is not None:
                warm_groups.setdefault(key, []).append(i)
        warmed: set[int] = set()
        for key, idxs in warm_groups.items():
            if len(idxs) < 2:
                continue
            idxs.sort(key=lambda i: specs[i].rounds)
            warmed.update(idxs)
            plans.append(_Plan("warm", idxs, reason="rounds-prefix group"))
            log.append(
                f"warm-start session reuse: specs {idxs} differ only in rounds "
                f"{[specs[i].rounds for i in idxs]} -- one session, reports "
                "emitted at each prefix"
            )
        seq = [(i, reason) for i, reason in seq if i not in warmed]

    for i, reason in seq:
        plans.append(_Plan("seq", [i], reason=reason))
        if batch_mode != "never":
            log.append(f"spec[{i}]: fallback to sequential solve() -- {reason}")
    return plans, log


# ---------------------------------------------------------------------------
# batched execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchedGroup:
    """One group ready to run: its specs ordered by compressor branch (each
    branch's rows one contiguous slice), the branch table, the stacked
    initial state and the batched round."""

    specs: list
    comp_idx: list[int]
    branch_keys: list[tuple[str, int]]
    state: Any
    round_fn: Any


def make_group(group: Sequence, z, vectorize: str = "scan") -> BatchedGroup:
    """The batched round of ``group`` (specs of one group key) on ``z``: the
    shared (n, n_i, d) tensor, or for "vmap" a stacked (S, n, n_i, d) one
    in the order of ``group`` sorted by branch (``branch_order``)."""
    from repro_torch.compressors import get_compressor
    from repro_torch.core.fednl_batch import fednl_batch_init
    from repro_torch.linalg import triu_size

    d = z.shape[-1]
    branch_keys, ordered = branch_order(group, d)
    comp_idx = [branch_keys.index(_branch_key(spec, d)) for spec in ordered]
    comps = [get_compressor(name, triu_size(d), k) for name, k in branch_keys]
    cfg0 = ordered[0].fednl_config()
    algo = get_algorithm(ordered[0].algorithm)
    state = fednl_batch_init(z, cfg0, [spec.seed for spec in ordered], vectorize)
    round_fn = algo.make_batch_round(
        z, cfg0, comps, comp_idx, resolved_alpha(ordered[0], d), vectorize)
    return BatchedGroup(ordered, comp_idx, branch_keys, state, round_fn)


def _branch_key(spec, d: int) -> tuple[str, int]:
    cfg = spec.fednl_config()
    return cfg.compressor, cfg.k_for(d)


def branch_order(group: Sequence, d: int) -> tuple[list[tuple[str, int]], list]:
    """The group's compressor branches, by first occurrence, and its specs
    sorted (stably) by branch."""
    keys: list[tuple[str, int]] = []
    for spec in group:
        if _branch_key(spec, d) not in keys:
            keys.append(_branch_key(spec, d))
    return keys, sorted(group, key=lambda spec: keys.index(_branch_key(spec, d)))


def _run_batched_group(
    specs: Sequence, idxs: list[int], z_for, vectorize: str, log: list[str], device
) -> dict[int, RunReport]:
    """Run one group: its specs' rounds advance together, each kernel
    launched once a round for the whole group.  Returns reports by index."""
    from repro_torch.api.backends import full_round_record, metric_rows
    from repro_torch.core.runner import RoundLoop
    from repro_torch.device import device_name

    d, n, _ = specs[idxs[0]].data.dims()
    cap = MAX_GROUP_CLIENTS // n
    if len(idxs) > cap:
        log.append(
            f"group of {len(idxs)} specs x {n} clients exceeds the SYRK kernel's "
            f"grid ({MAX_GROUP_CLIENTS} clients): split into groups of at most {cap}"
        )
        out: dict[int, RunReport] = {}
        for lo in range(0, len(idxs), cap):
            out.update(_run_batched_group(specs, idxs[lo:lo + cap], z_for, vectorize, log, device))
        return out

    keys, _ = branch_order([specs[i] for i in idxs], d)
    order = sorted(idxs, key=lambda i: keys.index(_branch_key(specs[i], d)))
    ordered = [specs[i] for i in order]
    if vectorize == "scan" or all(spec.data == ordered[0].data for spec in ordered):
        z = z_for(ordered[0])
    else:
        z = np.stack([z_for(spec) for spec in ordered])

    def start(zd):
        group = make_group(ordered, zd, vectorize)
        return group.state, group.round_fn

    # the sequential runner's loop: init, a warm-up round outside the clock,
    # then all the rounds as one chunk
    loop = RoundLoop(z, device, start)
    rounds = ordered[0].rounds
    s_count = len(ordered)
    metrics = loop.step(rounds)
    init_s, wall = loop.init_time_s, loop.wall_time_s

    log.append(
        f"batched {s_count} specs as one group: {ordered[0].algorithm}, "
        f"{len(keys)} compressor branch(es), {rounds} rounds, "
        f"{s_count * n} clients a SYRK launch, vectorize={vectorize}, devices=1 "
        f"(init {init_s:.2f}s, run {wall:.2f}s)"
    )
    rows = metric_rows(metrics)  # per round: (S,) host arrays by name
    x_final = loop.state.x.cpu().numpy()
    where = device_name(device)
    out = {}
    for b, (i, spec) in enumerate(zip(order, ordered)):
        records = [full_round_record(r, {k: v[b] for k, v in row.items()})
                   for r, row in enumerate(rows)]
        out[i] = RunReport(
            spec=spec,
            algorithm=spec.algorithm,
            backend=spec.backend,
            x=x_final[b],
            records=records,
            rounds=rounds,
            wall_time_s=wall / s_count,
            init_time_s=init_s / s_count,
            extras={
                "device": where,
                "sweep_batched": True,
                "batch_size": s_count,
                "batch_wall_time_s": wall,
                "batch_init_time_s": init_s,
                "vectorize": vectorize,
                "devices": 1,
                "compressor_branch": _branch_key(spec, d)[0],
            },
        )
    return out


# ---------------------------------------------------------------------------
# the sweep driver
# ---------------------------------------------------------------------------


def run_sweep(specs: Sequence, batch_mode: str, sweep: Any, device) -> SweepReport:
    """Plan ``specs`` and run every plan on ``device``."""
    from repro_torch.api.facade import solve
    from repro_torch.api.session import open_session

    t_start = time.perf_counter()
    plans, log = plan_sweep(specs, batch_mode)
    vectorize = "vmap" if batch_mode == "vmap" else "scan"

    z_cache: dict[Any, Any] = {}  # one data build per distinct DataSpec

    def z_for(spec):
        if spec.data not in z_cache:
            z_cache[spec.data] = spec.data.build()
        return z_cache[spec.data]

    reports: list[RunReport | None] = [None] * len(specs)
    batched_specs = 0
    for plan in plans:
        if plan.kind == "batch":
            for i, rep in _run_batched_group(
                specs, plan.indices, z_for, vectorize, log, device
            ).items():
                reports[i] = rep
            batched_specs += len(plan.indices)
        elif plan.kind == "warm":
            # step composability: every report equals its own solve()
            spec_max = specs[plan.indices[-1]]
            with open_session(spec_max, z=z_for(spec_max), device=device) as session:
                for i in plan.indices:
                    session.step(specs[i].rounds - session.round)
                    reports[i] = session.report(spec=specs[i])
        elif plan.kind == "pool":
            width = min(_POOL_WIDTH[plan.reason], len(plan.indices))
            log.append(f"pool: {len(plan.indices)} specs on {plan.reason} via "
                       f"{width} worker thread(s)")
            with ThreadPoolExecutor(max_workers=width) as pool:
                futures = [
                    pool.submit(solve, specs[i],
                                z=z_for(specs[i]) if get_backend(specs[i].backend).needs_problem
                                else None,
                                device=device)
                    for i in plan.indices
                ]
                for i, fut in zip(plan.indices, futures):
                    reports[i] = fut.result()
        else:
            (i,) = plan.indices
            reports[i] = solve(specs[i], z=z_for(specs[i]), device=device)

    return SweepReport(
        specs=tuple(specs),
        reports=reports,  # type: ignore[arg-type]
        log=log,
        wall_time_s=time.perf_counter() - t_start,
        sweep=sweep,
        extras={
            "batch_mode": batch_mode,
            "batched_specs": batched_specs,
            "n_groups": len(plans),
            "n_data_builds": len(z_cache),
            "devices": 1,
        },
    )
