"""Tenant bookkeeping for the FedNL serving engine (port of
``repro.serve_fednl.tenant``).

A *tenant* is one experiment admitted to the engine: its spec, resolved stop
policy, per-round records accumulated so far, and whichever runtime form it
currently has -- a live algorithm state on the batched lane (tensors on the
engine's device), an open :class:`repro_torch.api.session.Session` on the
solo lane, or a spilled FNLS1 checkpoint on disk.  The public face is
:class:`TenantHandle`, a thin view the submitting caller keeps while the
engine owns the tenant.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Any

from repro_torch.api.report import RoundRecord, RunReport
from repro_torch.api.session import StopPolicy

# tenant lifecycle: queued -> running <-> spilled -> finished
#                                    \-> evicted (explicit, checkpointed, leaves the engine)
#                                    \-> cancelled (explicit, state dropped, no checkpoint)
#                                    \-> failed  (solo-lane step exception)
QUEUED = "queued"
RUNNING = "running"
SPILLED = "spilled"
FINISHED = "finished"
EVICTED = "evicted"
CANCELLED = "cancelled"
FAILED = "failed"


@dataclasses.dataclass
class Tenant:
    """Engine-internal record of one admitted experiment (mutable)."""

    tenant_id: str
    spec: Any  # ExperimentSpec
    policy: StopPolicy
    lane: str  # "batch" | "solo"
    priority: str = "normal"  # admission class (scheduler.FairShareQueue)
    status: str = QUEUED
    round: int = 0
    records: list[RoundRecord] = dataclasses.field(default_factory=list)
    # batch lane runtime (None while queued/spilled/finished)
    algo: Any = None
    state: Any = None  # algorithm-state NamedTuple (tensors on the engine's device)
    comp_branch: tuple[str, int] | None = None  # (compressor name, k)
    group_key: tuple | None = None
    # solo lane runtime
    session: Any = None  # repro_torch.api.session.Session
    # spill / restore
    spill_path: pathlib.Path | None = None
    restore: Any = None  # pending SessionState (resume() admits through it)
    # accounting
    admitted_tick: int = -1
    last_active_tick: int = -1
    spill_count: int = 0
    wall_time_s: float = 0.0
    init_time_s: float = 0.0
    # obs.now() timestamp of the last queue entry (submit or spill re-queue);
    # feeds the engine.queue.wait_s histogram at admission
    enqueued_at: float = 0.0
    # result / failure
    report: RunReport | None = None
    error: BaseException | None = None
    done_event: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def cost(self) -> int:
        """Relative resident-memory cost of this tenant (packed Hessian
        state dominates: ~d^2 floats) -- the 'cost' eviction policy spills
        the most expensive tenants first."""
        d = self.spec.data.dims()[0]
        return d * d

    def finish(self, report: RunReport) -> None:
        self.report = report
        self.status = FINISHED
        self.state = None
        self.session = None
        self.done_event.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.status = FAILED
        self.state = None
        self.session = None
        self.done_event.set()


class TenantHandle:
    """Caller-side view of a submitted experiment.

    The engine advances the tenant on its own thread (or inside an explicit
    ``tick()`` / ``serve_until_idle()`` call); the handle only observes:
    ``status`` / ``round`` / ``records`` read the live tenant, ``wait()``
    blocks until the run finishes (or fails), and ``result()`` returns the
    final :class:`~repro_torch.api.report.RunReport` -- bit-identical,
    record for record, to a solo ``open_session(spec).run()`` on the CPU
    (on the card, see ``core/fednl_batch.py`` for what the batch lane
    shares with the solo run).
    """

    def __init__(self, tenant: Tenant):
        self._tenant = tenant

    @property
    def id(self) -> str:
        return self._tenant.tenant_id

    @property
    def spec(self):
        return self._tenant.spec

    @property
    def status(self) -> str:
        return self._tenant.status

    @property
    def round(self) -> int:
        return self._tenant.round

    @property
    def records(self) -> tuple[RoundRecord, ...]:
        return tuple(self._tenant.records)

    @property
    def priority(self) -> str:
        return self._tenant.priority

    @property
    def done(self) -> bool:
        return self._tenant.status in (FINISHED, FAILED, EVICTED, CANCELLED)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the tenant finishes or fails (True) or the timeout
        expires (False).  Only useful with a started engine thread -- a
        synchronous caller drives ``tick()`` itself instead."""
        return self._tenant.done_event.wait(timeout)

    def result(self) -> RunReport:
        """The final report.  Raises if the run failed, was evicted, or has
        not finished yet (drive the engine first)."""
        t = self._tenant
        if t.status == FAILED:
            raise RuntimeError(f"tenant {t.tenant_id!r} failed") from t.error
        if t.status == EVICTED:
            raise RuntimeError(
                f"tenant {t.tenant_id!r} was evicted to "
                f"{t.spill_path} — resume it with "
                "FedNLServer.resume(path) or open_session(spec, restore=path)"
            )
        if t.status == CANCELLED:
            raise RuntimeError(
                f"tenant {t.tenant_id!r} was cancelled (state dropped, no "
                "checkpoint); resubmit the spec to run it again"
            )
        if t.report is None:
            raise RuntimeError(
                f"tenant {t.tenant_id!r} has not finished "
                f"(status {t.status!r}); call tick()/serve_until_idle() or "
                "wait() on a started engine"
            )
        return t.report

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        t = self._tenant
        return (
            f"TenantHandle({t.tenant_id!r}, status={t.status!r}, "
            f"round={t.round}, lane={t.lane!r})"
        )
