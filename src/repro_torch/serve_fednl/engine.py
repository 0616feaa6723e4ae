"""`FedNLServer` -- the multi-tenant FedNL serving event loop (port of
``repro.serve_fednl.engine``).

One engine multiplexes many concurrent experiments (tenants) through the
continuous-batching scheduler (``repro_torch.serve_fednl.scheduler``):
every ``tick()`` admits queued tenants up to capacity, spills resident
tenants to FNLS1 checkpoints under memory pressure
(``repro_torch.serve_fednl.spill``), re-forms the batching groups, advances
every in-flight tenant exactly ONE round -- batched tenants through one
batched round per group chunk (one SYRK launch on all its slots' clients,
one selection launch per compressor branch), solo tenants through their
open :class:`repro_torch.api.session.Session` -- and applies each tenant's
:class:`~repro_torch.api.session.StopPolicy` per slot.

    server = FedNLServer(ServeConfig(max_resident=16))   # on the card
    handles = [server.submit(spec) for spec in specs]
    server.serve_until_idle()          # or server.start() for a thread
    reports = [h.result() for h in handles]

Everything runs on the engine's device: the card unless ``device="cpu"``
is asked for, as ``solve`` and ``open_session`` do.

Numerics: on the CPU every record of every served tenant is bit-identical
to a solo ``open_session(spec).run()`` -- whatever it was batched with, in
what order the tenants arrived, or how often it was spilled and resumed
(``tests/test_torch_serve_fednl.py``).  On the card a batched tenant shares
its solo run's bits op for op but for the batched Cholesky (ROADMAP C6,
``core/fednl_batch.py``); ``chip_smoke.py`` phase 12 holds it to its
``solve()`` with exact bits and grad norms within the sweep's rtol, and
solo-lane tenants are their sessions bit for bit.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Any

import torch

from repro_torch.api.backends import full_round_record, restored_state
from repro_torch.api.report import RunReport, RunReportBuilder
from repro_torch.api.session import SessionState, load_state, open_session, resolve_policy
from repro_torch.device import device_name, resolve_device
from repro_torch.obs import core as obs
from repro_torch.serve_fednl.scheduler import (
    DEFAULT_PRIORITIES,
    DEFAULT_PRIORITY,
    FairShareQueue,
    GroupRuntime,
    SubmitOptions,
    serve_group_key,
    serve_lane,
)
from repro_torch.serve_fednl.spill import SpillManager
from repro_torch.serve_fednl.tenant import (
    CANCELLED,
    EVICTED,
    FINISHED,
    QUEUED,
    RUNNING,
    SPILLED,
    Tenant,
    TenantHandle,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine sizing and policy knobs.

    ``max_resident`` caps how many tenants hold live (device) state at once
    -- beyond it, victims spill to disk and re-queue (round-robin
    time-slicing).  ``admit_per_tick`` bounds admission work per tick.
    ``max_group`` caps slots per batched round.  ``eviction`` picks the
    spill victim policy (``"lru"`` | ``"cost"``).  ``spill_dir`` is where
    checkpoints go (default: a private temporary directory, removed at
    shutdown).  ``pad_pow2`` pads batch slot counts to powers of two, as
    the reference pads them to reuse its compiled tick programs.
    ``priorities`` names the admission classes and their fair-share weights
    (deficit round-robin over class queues; a single class degenerates to
    FIFO); ``quantum`` scales the per-cycle DRR credit.
    """

    max_resident: int = 16
    admit_per_tick: int = 8
    max_group: int = 16
    eviction: str = "lru"
    spill_dir: str | pathlib.Path | None = None
    pad_pow2: bool = True
    priorities: dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PRIORITIES)
    )
    quantum: float = 1.0


class FedNLServer:
    """Serve many FedNL experiments through one engine (module docstring).

    Thread model: ``submit``/``resume`` only enqueue (cheap, lock-guarded);
    all device work happens inside ``tick()`` -- called either
    synchronously (``tick``/``serve_until_idle``) or by the single
    background thread ``start()`` spawns, or by the gateway on its worker
    threads.  One lock serializes ticks against queue mutation, eviction
    and cancellation.
    """

    def __init__(self, config: ServeConfig | None = None, device=None):
        self.config = config or ServeConfig()
        if self.config.max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._queue = FairShareQueue(self.config.priorities, quantum=self.config.quantum)
        # the class submit() falls back to when no SubmitOptions is given
        self._default_priority = (
            DEFAULT_PRIORITY
            if DEFAULT_PRIORITY in self.config.priorities
            else self._queue._order[0]
        )
        self._tenants: dict[str, Tenant] = {}
        self._groups: dict[tuple, GroupRuntime] = {}
        self._spill = SpillManager(self.config.spill_dir, policy=self.config.eviction)
        self._z_cache: dict[Any, Any] = {}  # DataSpec -> numpy z (host)
        self._z_dev: dict[Any, torch.Tensor] = {}  # DataSpec -> z on the device
        self._counter = 0
        self._ticks = 0
        self._finished = 0
        self._failed = 0
        self._evicted = 0
        self._cancelled = 0
        self._launches = 0
        self._slots_live = 0
        self._slots_padded = 0
        self._admissions_by_class = {p: 0 for p in self.config.priorities}
        self._rounds_by_class = {p: 0 for p in self.config.priorities}
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._shut = False

    # --- intake -----------------------------------------------------------

    def submit(
        self,
        spec,
        until=None,
        tenant_id: str | None = None,
        options: SubmitOptions | None = None,
    ) -> TenantHandle:
        """Enqueue one experiment; returns immediately with a handle.

        ``until`` follows :meth:`repro_torch.api.session.Session.run` (None |
        int | float | StopPolicy); ``options`` picks the admission priority
        class (:class:`~repro_torch.serve_fednl.scheduler.SubmitOptions`).
        Validation is upfront and SYNCHRONOUS: anything ``solve()`` would
        reject -- plus a bad compressor/k, an unresolvable alpha, a bad tau,
        an unknown priority class -- is rejected here, before it ever
        reaches a tick (a remote SUBMIT gets an error frame naming the
        field, not a dead tenant discovered ticks later).
        """
        from repro_torch.api.batch import resolved_alpha
        from repro_torch.api.facade import check_spec
        from repro_torch.api.registry import get_algorithm, get_backend
        from repro_torch.compressors import get_compressor
        from repro_torch.linalg import triu_size

        algo = get_algorithm(spec.algorithm)
        backend = get_backend(spec.backend)
        check_spec(spec, algo, backend)
        # resolve the compressor upfront: a bad name/k must fail the submit,
        # not detonate inside a later tick that serves other tenants too
        d, n_clients, _ = spec.data.dims()
        cfg = spec.fednl_config()
        get_compressor(cfg.compressor, triu_size(d), cfg.k_for(d))
        # resolve everything else _admit would have resolved lazily: the
        # Hessian learning rate and, for PP, the participation size
        resolved_alpha(spec, d)
        if algo.kind == "pp":
            spec.tau_for(n_clients)
        if not backend.supports_sessions:
            raise ValueError(
                f"backend {spec.backend!r} does not support sessions and "
                "cannot be served; run it with solve(spec) instead"
            )
        policy = resolve_policy(until, spec)
        if policy.tol is not None and algo.kind == "pp":
            raise ValueError(
                "tol-based stopping is undefined for partial participation "
                "(the server never sees the global gradient); use max_rounds "
                "or a predicate on the records instead"
            )
        return self._enqueue(
            spec, policy, serve_lane(spec, algo, backend), tenant_id,
            self._resolve_priority(options),
        )

    def resume(
        self,
        checkpoint,
        until=None,
        tenant_id: str | None = None,
        options: SubmitOptions | None = None,
    ) -> TenantHandle:
        """Re-admit a spilled/evicted/external FNLS1 checkpoint (a path from
        :meth:`evict`, :meth:`Session.save` or either package's engine, or a
        :class:`~repro_torch.api.session.SessionState`).  The run continues
        from its checkpointed round."""
        from repro_torch.api.registry import get_algorithm, get_backend

        state = checkpoint if isinstance(checkpoint, SessionState) else load_state(checkpoint)
        spec = state.spec
        algo = get_algorithm(spec.algorithm)
        backend = get_backend(spec.backend)
        policy = resolve_policy(until, spec)
        lane = serve_lane(spec, algo, backend)
        if lane == "batch" and state.backend != "local":
            lane = "solo"  # foreign state layout: replay through its backend
        handle = self._enqueue(spec, policy, lane, tenant_id, self._resolve_priority(options))
        t = handle._tenant
        t.restore = state
        t.round = int(state.round)
        t.records = list(state.records)
        return handle

    def _resolve_priority(self, options: SubmitOptions | None) -> str:
        if options is None:
            return self._default_priority
        if not isinstance(options, SubmitOptions):
            raise TypeError(f"options must be a SubmitOptions, got {type(options).__name__}")
        options.validate(self.config.priorities)
        return options.priority

    def _enqueue(self, spec, policy, lane, tenant_id, priority) -> TenantHandle:
        with self._lock:
            if self._shut:
                raise RuntimeError("engine is shut down")
            if tenant_id is None:
                tenant_id = f"t{self._counter:04d}"
                self._counter += 1
            if tenant_id in self._tenants:
                raise ValueError(f"tenant id {tenant_id!r} already in use")
            t = Tenant(tenant_id=tenant_id, spec=spec, policy=policy, lane=lane, priority=priority)
            self._tenants[tenant_id] = t
            t.enqueued_at = obs.now()
            self._queue.push(t)
            return TenantHandle(t)

    # --- the tick ---------------------------------------------------------

    def tick(self) -> dict:
        """One scheduling round: pressure -> admit -> batch -> solo.

        Returns a small stats dict for this tick (admitted, spilled, groups,
        live/padded slot counts, finished).  With a live ``repro_torch.obs``
        recorder installed the tick is wrapped in an ``engine.tick`` span
        (fields: admitted/spilled/groups/slots/finished and the ``compiles``
        delta of the round tables) and feeds the engine.* counters, gauges
        and histograms -- host scalars only, never touching the numbers."""
        rec = obs.CURRENT
        with self._lock, rec.span("engine.tick") as sp:
            if self._shut:
                raise RuntimeError("engine is shut down")
            self._ticks += 1
            now = self._ticks
            compiles0 = sum(g.compiles for g in self._groups.values()) if rec.enabled else 0
            out = {"tick": now, "admitted": 0, "spilled": 0, "groups": 0,
                   "slots": 0, "slots_padded": 0, "finished": 0}

            # 1. memory pressure: make room for queued tenants by spilling
            # resident ones (victims re-queue at the back of their class
            # queue -> round-robin time-slicing within each class)
            resident = [t for t in self._tenants.values() if t.status == RUNNING]
            admittable = min(len(self._queue), self.config.admit_per_tick)
            free = self.config.max_resident - len(resident)
            if admittable > free:
                for v in self._spill.pick_victims(resident, admittable - free, now):
                    self._spill.spill(v)
                    v.enqueued_at = obs.now()
                    self._queue.push(v)
                    out["spilled"] += 1

            # 2. admission: deficit round-robin over the priority classes
            # (FIFO within a class; resumes restore their checkpointed state)
            n_res = sum(1 for t in self._tenants.values() if t.status == RUNNING)
            admitted = 0
            while (
                self._queue
                and admitted < self.config.admit_per_tick
                and n_res < self.config.max_resident
            ):
                t = self._queue.pop()
                if t is None or t.status in (EVICTED, CANCELLED):
                    continue  # evicted/cancelled while queued
                if rec.enabled and t.enqueued_at:
                    rec.observe("engine.queue.wait_s", obs.now() - t.enqueued_at, cls=t.priority)
                    rec.add("engine.admissions", cls=t.priority)
                self._admit(t, now)
                admitted += 1
                self._admissions_by_class[t.priority] += 1
                if t.status == RUNNING:
                    n_res += 1
                elif t.status == FINISHED:
                    out["finished"] += 1
            out["admitted"] = admitted

            # 3. batched lane: re-form groups, one batched round per chunk
            running = [t for t in self._tenants.values() if t.status == RUNNING]
            groups: dict[tuple, list[Tenant]] = {}
            for t in running:
                if t.lane == "batch":
                    groups.setdefault(t.group_key, []).append(t)
            for key, members in groups.items():
                rt = self._groups[key]
                for lo in range(0, len(members), self.config.max_group):
                    chunk = members[lo : lo + self.config.max_group]
                    t1 = obs.now()
                    metrics, n_pad = rt.tick_group(chunk, pad_pow2=self.config.pad_pow2)
                    launch_s = obs.now() - t1  # the metrics' copy to the host ends it
                    per = launch_s / len(chunk)
                    if rec.enabled:
                        rec.observe("engine.batch.launch_s", launch_s)
                        rec.observe("engine.group.slots", len(chunk))
                        rec.add("engine.rounds", len(chunk), lane="batch")
                    self._launches += 1
                    self._slots_live += len(chunk)
                    self._slots_padded += n_pad
                    out["groups"] += 1
                    out["slots"] += len(chunk)
                    out["slots_padded"] += n_pad
                    for t, m in zip(chunk, metrics):
                        t.wall_time_s += per
                        rr = full_round_record(t.round, m)
                        t.records.append(rr)
                        t.round += 1
                        self._rounds_by_class[t.priority] += 1
                        t.last_active_tick = now
                        if t.policy.hit(rr) or t.round >= t.policy.max_rounds:
                            self._finish_batch(t)
                            out["finished"] += 1

            # 4. solo lane: one Session round per tenant per tick
            for t in running:
                if t.lane != "solo" or t.status != RUNNING:
                    continue
                try:
                    recs = t.session.step(1)
                except Exception as exc:  # tenant-local failure, not engine
                    try:
                        t.session.close()
                    except Exception:
                        pass
                    self._failed += 1
                    t.fail(exc)
                    continue
                t.last_active_tick = now
                if recs:
                    t.records.append(recs[0])
                    t.round = t.session.round
                    self._rounds_by_class[t.priority] += 1
                    if rec.enabled:
                        rec.add("engine.rounds", lane="solo")
                if not recs or t.policy.hit(recs[0]) or t.round >= t.policy.max_rounds:
                    self._finish_solo(t)
                    out["finished"] += 1

            if rec.enabled:
                if out["spilled"]:
                    rec.add("engine.spills", out["spilled"])
                for cls_name, depth in self._queue.backlog().items():
                    rec.gauge("engine.queue.depth", depth, cls=cls_name)
                rec.gauge(
                    "engine.resident",
                    sum(1 for t in self._tenants.values() if t.status == RUNNING),
                )
                sp.set(
                    tick=now,
                    admitted=out["admitted"],
                    spilled=out["spilled"],
                    groups=out["groups"],
                    slots=out["slots"],
                    finished=out["finished"],
                    compiles=sum(g.compiles for g in self._groups.values()) - compiles0,
                )
            return out

    def _z_for(self, spec):
        """The spec's problem data on the host (built once per DataSpec)."""
        if spec.data not in self._z_cache:
            self._z_cache[spec.data] = spec.data.build()
        return self._z_cache[spec.data]

    def _z_on_device(self, spec) -> torch.Tensor:
        """The spec's problem data as f64 on the engine's device (uploaded
        once per DataSpec): the batch lane's shared z."""
        if spec.data not in self._z_dev:
            self._z_dev[spec.data] = torch.as_tensor(self._z_for(spec)).to(
                dtype=torch.float64, device=self.device).contiguous()
        return self._z_dev[spec.data]

    def _admit(self, t: Tenant, now: int) -> None:
        from repro_torch.api.batch import resolved_alpha
        from repro_torch.api.registry import get_algorithm, get_backend

        resumed = t.status == SPILLED or t.restore is not None
        if t.lane == "solo":
            backend = get_backend(t.spec.backend)
            z = self._z_for(t.spec) if backend.needs_problem else None
            restore = t.spill_path if t.status == SPILLED else t.restore
            t0 = obs.now()
            t.session = open_session(t.spec, z=z, restore=restore, device=self.device)
            t.init_time_s += obs.now() - t0
            t.restore = None
            t.round = t.session.round
            t.records = list(t.session.records)
        else:
            algo = get_algorithm(t.spec.algorithm)
            t.algo = algo
            z = self._z_on_device(t.spec)
            d = int(z.shape[-1])
            cfg = t.spec.fednl_config()
            t0 = obs.now()
            # the initial state even for a resumed tenant (one SYRK launch),
            # as the reference admits: the restored arrays replace it
            state = algo.init(z, cfg, x0=None, seed=t.spec.seed)
            restore = None
            if t.status == SPILLED:
                restore = load_state(t.spill_path)
            elif t.restore is not None:
                restore = t.restore
            if restore is not None:
                state = restored_state(state, restore, self.device)
                t.round = int(restore.round)
                t.restore = None
            t.state = state
            t.init_time_s += obs.now() - t0
            t.comp_branch = (cfg.compressor, cfg.k_for(d))
            t.group_key = serve_group_key(t.spec, d)
            if t.group_key not in self._groups:
                self._groups[t.group_key] = GroupRuntime(
                    z, cfg, resolved_alpha(t.spec, d), algo.make_batch_round
                )
        if resumed:
            self._spill.resume_count += 1
        t.status = RUNNING
        t.admitted_tick = now
        t.last_active_tick = now
        # a tenant admitted at (or past) its round budget finishes at once
        # (solve()'s rounds=0 semantics: INIT only, no rounds)
        if t.round >= t.policy.max_rounds:
            if t.lane == "solo":
                self._finish_solo(t)
            else:
                self._finish_batch(t)

    # --- completion -------------------------------------------------------

    def _finish_batch(self, t: Tenant) -> None:
        builder = RunReportBuilder(t.spec, t.algo.name, "local")
        builder.extend(t.records)
        report = builder.build(
            x=t.state.x.cpu().numpy(),
            wall_time_s=t.wall_time_s,
            init_time_s=t.init_time_s,
            extras={"device": device_name(self.device), "served": True,
                    "spills": t.spill_count},
        )
        t.finish(report)
        self._finished += 1

    def _finish_solo(self, t: Tenant) -> None:
        report = t.session.report()
        report.extras["served"] = True
        report.extras["spills"] = t.spill_count
        sess = t.session
        t.finish(report)
        sess.close()
        self._finished += 1

    # --- eviction / persistence -------------------------------------------

    def evict(self, tenant_id: str) -> pathlib.Path:
        """Gracefully evict one tenant: checkpoint it to disk (closing any
        wire transports it held) and remove it from scheduling.  Returns the
        FNLS1 path -- an ordinary session checkpoint, resumable with
        :meth:`resume` or ``open_session(spec, restore=path)``."""
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is None:
                raise KeyError(f"no tenant {tenant_id!r}")
            if t.status == RUNNING:
                self._spill.spill(t)
            elif t.status == QUEUED and t.restore is not None:
                # never materialized: persist the pending restore state
                from repro_torch.api.session import save_state

                t.spill_path = self._spill.path_for(t)
                save_state(t.restore, t.spill_path)
            elif t.status != SPILLED:
                raise ValueError(
                    f"tenant {tenant_id!r} is {t.status!r}; only queued/"
                    "running/spilled tenants can be evicted"
                )
            t.status = EVICTED
            t.restore = None
            self._evicted += 1
            t.done_event.set()
            return t.spill_path

    def cancel(self, tenant_id: str) -> None:
        """Drop one tenant without a checkpoint: its device/session state is
        released, any spill file is deleted, and the id leaves scheduling.
        Unlike :meth:`evict` nothing survives -- ``result()`` raises and the
        spec must be resubmitted to run again.  Finished/failed tenants keep
        their outcome (cancelling them is an error)."""
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is None:
                raise KeyError(f"no tenant {tenant_id!r}")
            if t.status not in (QUEUED, RUNNING, SPILLED):
                raise ValueError(
                    f"tenant {tenant_id!r} is {t.status!r}; only queued/"
                    "running/spilled tenants can be cancelled"
                )
            if t.status == RUNNING and t.session is not None:
                try:
                    t.session.close()
                except Exception:
                    pass
            if t.spill_path is not None:
                try:
                    t.spill_path.unlink(missing_ok=True)
                except OSError:
                    pass
            t.session = None
            t.state = None
            t.restore = None
            t.status = CANCELLED
            self._cancelled += 1
            t.done_event.set()

    # --- driving ----------------------------------------------------------

    def _has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                t.status in (RUNNING, SPILLED) for t in self._tenants.values()
            )

    def serve_until_idle(self, max_ticks: int | None = None) -> int:
        """Tick until every tenant is finished/failed/evicted; returns the
        number of ticks run.  ``max_ticks`` is a runaway guard."""
        n = 0
        while self._has_work():
            self.tick()
            n += 1
            if max_ticks is not None and n >= max_ticks:
                raise RuntimeError(f"serve_until_idle exceeded max_ticks={max_ticks}")
        return n

    def start(self) -> None:
        """Spawn the background serving thread (idempotent).  Callers just
        submit() and wait()."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._serve_loop, name="fednl-serve", daemon=True)
        self._thread.start()

    def _serve_loop(self) -> None:
        while not self._stop_evt.is_set():
            if self._has_work():
                self.tick()
            else:
                self._stop_evt.wait(0.002)

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the background thread (tenants keep their state; ticking can
        resume via tick()/start())."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def shutdown(self, spill: bool = False) -> None:
        """Tear the engine down.  With ``spill=True`` every live tenant is
        checkpointed first (set an explicit ``spill_dir`` to keep the files
        past shutdown); queued-only tenants are simply evicted.  Always
        closes every solo session -- no wire transport (star-tcp client
        fleet) survives the engine."""
        self.stop()
        with self._lock:
            if self._shut:
                return
            for t in self._tenants.values():
                if t.status == RUNNING:
                    if spill:
                        self._spill.spill(t)
                    elif t.session is not None:
                        try:
                            t.session.close()
                        except Exception:
                            pass
                    t.session = None
                    t.state = None
                if t.status in (QUEUED, RUNNING, SPILLED):
                    t.status = EVICTED
                    self._evicted += 1
                    t.done_event.set()
            self._queue.clear()
            if self.config.spill_dir is None:
                self._spill.cleanup()  # private tmp dir: nothing to keep
            self._shut = True

    def __enter__(self) -> "FedNLServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(spill=False)

    # --- introspection ----------------------------------------------------

    def stats(self) -> dict:
        """Cumulative engine counters (occupancy = live slots / padded
        slots across every batched round)."""
        with self._lock:
            statuses: dict[str, int] = {}
            for t in self._tenants.values():
                statuses[t.status] = statuses.get(t.status, 0) + 1
            return {
                "ticks": self._ticks,
                "tenants": len(self._tenants),
                "finished": self._finished,
                "failed": self._failed,
                "evicted": self._evicted,
                "cancelled": self._cancelled,
                "queued": len(self._queue),
                "backlog": self._queue.backlog(),
                "admissions_by_class": dict(self._admissions_by_class),
                "rounds_by_class": dict(self._rounds_by_class),
                "statuses": statuses,
                "spills": self._spill.spill_count,
                "resumes": self._spill.resume_count,
                "batch_launches": self._launches,
                "batch_occupancy": (
                    self._slots_live / self._slots_padded if self._slots_padded else None
                ),
                "compiles": sum(g.compiles for g in self._groups.values()),
                "groups": len(self._groups),
            }


def serve_all(specs, config: ServeConfig | None = None, device=None) -> list[RunReport]:
    """Convenience: serve ``specs`` to completion through one engine on
    ``device`` and return their reports in order (the serving analogue of
    ``solve_many`` for heterogeneous, stop-policy-bearing runs)."""
    with FedNLServer(config, device=device) as server:
        handles = [server.submit(spec) for spec in specs]
        server.serve_until_idle()
        return [h.result() for h in handles]
