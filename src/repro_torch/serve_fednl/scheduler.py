"""Continuous-batching scheduler: group keys, lanes, and the batched tick
(port of ``repro.serve_fednl.scheduler``).

Every engine *tick*, the in-flight tenants are re-partitioned into batching
groups; each group advances ONE round through the batched round of its
:class:`repro_torch.core.fednl_batch.BatchRoundTable`; then stop policies
are checked per slot and the groups dissolve.  Tenants are admitted, finish,
or spill **between** ticks, so group membership is recomputed every time --
the tables are what persists.

What may share a group:

* the same **serve group key** -- everything that shapes the round except
  the compressor, the seed, the round budget and the stop tolerance:
  ``(algorithm, data, objective, lam, option, mu, hess0, accounting,
  ls_*, alpha)``.  The data is part of the key because a group shares one z
  (the "scan" layout of ``core/fednl_batch.py``).
* **arbitrary, differing round indices.**  Each slot's round index is its
  own (``state.round`` is a host array over the slots); nothing in the
  round depends on a shared round index, so a tenant at round 37 and one
  at round 0 co-batch.  This is the continuous part of continuous batching
  -- the sweep engine's loop over a common ``rounds`` is replaced by the
  host tick loop.
* **different compressors / k / seeds.**  A branch per (compressor, k):
  one selection launch per branch in the chunk, one threefry launch per
  uniform dtype; seeds live in each slot's PRNG key.
* ``tol`` differs freely: the engine reads every slot's metrics to the host
  every tick anyway (one sync per group chunk), so per-slot tol stopping
  costs nothing extra -- this is why tol early-stop blocks the *sweep*
  batch lane but not the *serve* one.

Padding: slot counts are padded up to powers of two by duplicating slot 0
(``BatchRoundTable.bucket_for``), as the reference pads its compiled tick
programs; here the pad slots cost device work (SYRK and the selections run
on them too) and bound nothing, but they keep the reference's ``compiles``,
``batch_occupancy`` and slot counts.  A pad slot cannot shape a live slot's
bits (``core/fednl_batch.py``).

Admission: tenants wait in per-priority-class queues served by deficit
round-robin (:class:`FairShareQueue`).  Each class ``c`` has a configured
weight ``w_c``; per DRR cycle a class earns ``quantum * w_c`` admission
credit and spends 1 credit per admitted tenant, so under saturation class
admission rates converge to the weight ratios exactly.  An empty class's
deficit resets to zero (no credit hoarding), FIFO order holds within a
class, and the head of a backlogged class ``c`` waits at most

    ceil(1 / (quantum * w_c)) * sum_{j != c} (quantum * w_j + 1)

foreign admissions (:meth:`FairShareQueue.starvation_bound`).  Spill
victims re-enter the *back* of their class queue, so round-robin
time-slicing happens per class and the fair share composes with memory
pressure.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from repro_torch.api.batch import resolved_alpha
from repro_torch.core.fednl_batch import BatchRoundTable

# default priority classes (ServeConfig.priorities overrides); weights are
# admission shares under saturation, not absolute rates
DEFAULT_PRIORITIES = {"high": 4.0, "normal": 2.0, "low": 1.0}

DEFAULT_PRIORITY = "normal"


@dataclasses.dataclass(frozen=True)
class SubmitOptions:
    """Per-submission scheduling choices (``FedNLServer.submit(options=...)``,
    and the SUBMIT payload over the gateway).

    ``priority`` names one of the engine's configured priority classes
    (``ServeConfig.priorities``; defaults high/normal/low at weights 4/2/1).
    Validation happens at submission -- an unknown class is a synchronous
    error naming the field, never a dead tenant discovered ticks later.
    """

    priority: str = DEFAULT_PRIORITY

    def validate(self, classes: dict[str, float]) -> None:
        if not isinstance(self.priority, str) or self.priority not in classes:
            raise ValueError(
                f"options.priority: unknown priority class "
                f"{self.priority!r}; this engine's configured classes are "
                f"{' | '.join(sorted(classes))}"
            )


class FairShareQueue:
    """Deficit-round-robin admission queue over weighted priority classes.

    ``push`` appends to the tenant's class queue (FIFO within class);
    ``pop`` returns the next tenant under DRR (module docstring).  Class
    iteration order is fixed (descending weight, then name) so the service
    pattern -- and therefore the starvation bound -- is deterministic.
    All state mutation happens under the engine lock (the engine is the
    only caller); this class itself is not thread-safe.
    """

    def __init__(self, classes: dict[str, float], quantum: float = 1.0):
        if not classes:
            raise ValueError("need at least one priority class")
        for name, w in classes.items():
            if not (isinstance(w, (int, float)) and w > 0):
                raise ValueError(f"priority class {name!r} needs a positive weight, got {w!r}")
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.weights = {name: float(w) for name, w in classes.items()}
        self.quantum = float(quantum)
        self._order = sorted(self.weights, key=lambda n: (-self.weights[n], n))
        self._queues: dict[str, deque] = {n: deque() for n in self._order}
        self._deficit: dict[str, float] = {n: 0.0 for n in self._order}
        self._ptr = 0
        self._in_service = False
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def push(self, tenant, priority: str | None = None) -> None:
        """Enqueue ``tenant`` at the back of its class queue.  ``priority``
        overrides ``tenant.priority`` (used by tests driving bare objects)."""
        name = priority if priority is not None else tenant.priority
        if name not in self._queues:
            raise ValueError(
                f"unknown priority class {name!r}; configured classes are "
                f"{' | '.join(sorted(self.weights))}"
            )
        self._queues[name].append(tenant)
        self._n += 1

    def _advance(self) -> None:
        self._ptr = (self._ptr + 1) % len(self._order)
        self._in_service = False

    def pop(self):
        """Dequeue the next tenant under DRR, or None when empty."""
        if self._n == 0:
            return None
        while True:
            name = self._order[self._ptr]
            q = self._queues[name]
            if not q:
                # empty class: reset credit (no hoarding) and move on
                self._deficit[name] = 0.0
                self._advance()
                continue
            if not self._in_service:
                # entering this class's service turn: earn one quantum
                self._deficit[name] += self.quantum * self.weights[name]
                self._in_service = True
            if self._deficit[name] >= 1.0:
                self._deficit[name] -= 1.0
                self._n -= 1
                return q.popleft()
            # credit exhausted for this turn; next class
            self._advance()

    def clear(self) -> None:
        for q in self._queues.values():
            q.clear()
        for name in self._deficit:
            self._deficit[name] = 0.0
        self._n = 0
        self._ptr = 0
        self._in_service = False

    def backlog(self) -> dict[str, int]:
        """Queued tenants per class (introspection / stats)."""
        return {n: len(q) for n, q in self._queues.items()}

    def starvation_bound(self, priority: str) -> int:
        """Max foreign admissions before the head of ``priority``'s queue is
        admitted, per the DRR analysis in the module docstring."""
        w = self.weights[priority]
        cycles = math.ceil(1.0 / (self.quantum * w))
        per_cycle = sum(self.quantum * wj + 1 for n, wj in self.weights.items() if n != priority)
        return int(math.ceil(cycles * per_cycle))


def serve_lane(spec, algo, backend) -> str:
    """Which lane serves this spec: "batch" (the batched tick) or "solo"
    (a per-tenant Session stepped one round per tick).

    The sweep's batch blockers (``api.batch._batch_blockers``) minus the two
    that do not apply to serving: ``tol > 0`` (the tick reads every slot's
    metrics anyway) and ``rounds == 0`` (a zero-round tenant just finishes
    at admission).  ``hessian="pallas"`` takes the solo lane, as in the
    reference.
    """
    from repro_torch.api.backends import LOCAL_BACKEND

    if (
        backend is LOCAL_BACKEND
        and algo.make_batch_round is not None
        and algo.kind == "full"
        and spec.hessian_impl != "pallas"
    ):
        return "batch"
    return "solo"


def serve_group_key(spec, d: int) -> tuple:
    """Co-scheduling key (module docstring): the sweep's group key minus
    ``rounds`` -- round budgets are per-slot stop conditions here."""
    return (
        spec.algorithm,
        spec.data,
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
        resolved_alpha(spec, d),
    )


def stack_states(states: list):
    """Per-tenant states -> one state stacked on a leading slot axis: tensors
    by ``torch.stack``, the host keys by ``np.stack``, the rounds as a host
    int64 array (one round index a slot)."""
    first = states[0]
    fields = {}
    for name in first._fields:
        values = [getattr(st, name) for st in states]
        if isinstance(values[0], torch.Tensor):
            fields[name] = torch.stack(values)
        elif name == "round":
            fields[name] = np.asarray(values, dtype=np.int64)
        else:
            fields[name] = np.stack([np.asarray(v) for v in values])
    return type(first)(**fields)


def unstack_state(state_b, i: int):
    """Slot ``i`` of a stacked state, as one tenant's state (its round a
    Python int, as the solo round keeps it)."""
    return type(state_b)(**{
        name: int(value[i]) if name == "round" else value[i]
        for name, value in zip(state_b._fields, state_b)
    })


def host_metrics(metrics_b, n: int) -> list[dict]:
    """The batched round's metrics -> one dict of host values per live slot,
    in ONE device-to-host copy: every column as 64-bit words (the float64
    columns reinterpreted, bit for bit) stacked into one int64 tensor."""
    dev = {name: v for name, v in zip(metrics_b._fields, metrics_b) if isinstance(v, torch.Tensor)}
    table = {name: np.asarray(v) for name, v in zip(metrics_b._fields, metrics_b)
             if not isinstance(v, torch.Tensor)}  # FedNL-LS's ls_steps, counted on the host
    words = torch.stack([v.view(torch.int64) if v.dtype == torch.float64 else v.to(torch.int64)
                         for v in dev.values()]).cpu().numpy()
    for (name, v), row in zip(dev.items(), words):
        table[name] = row.view(np.float64) if v.dtype == torch.float64 else row
    return [{name: col[i] for name, col in table.items()} for i in range(n)]


class GroupRuntime:
    """One serve group key's persistent machinery: the problem ``z`` (on the
    engine's device), the growable compressor branch table and the rounds
    by branch pattern, all owned by a
    :class:`~repro_torch.core.fednl_batch.BatchRoundTable`."""

    def __init__(self, z, cfg, alpha: float, make_batch_round):
        self.table = BatchRoundTable(z, cfg, alpha, make_batch_round=make_batch_round)

    @property
    def compiles(self) -> int:
        return self.table.compiles

    def branch_index(self, name: str, k: int) -> int:
        return self.table.branch_index(name, k)

    def tick_group(self, tenants: list, pad_pow2: bool = True):
        """Advance every tenant in ``tenants`` one round.

        Stacks the per-tenant states along a slot axis (padding to the
        group's slot bucket by duplicating slot 0), runs the table's round,
        unstacks, and returns ``(metrics, n_pad)``: one dict of host metric
        values per tenant, in tenant order (one device-to-host copy for the
        chunk), and the padded slot count launched.  The caller makes the
        records and applies the stop policies.
        """
        states = [t.state for t in tenants]
        comp_idx = [self.branch_index(*t.comp_branch) for t in tenants]
        n = len(tenants)
        # branch indices resolved first: bucket choice depends on the
        # (possibly grown) table length
        n_pad = self.table.bucket_for(n, pad_pow2)
        if n_pad > n:
            states = states + [states[0]] * (n_pad - n)
            comp_idx = comp_idx + [comp_idx[0]] * (n_pad - n)
        state_b, metrics_b = self.table.tick(comp_idx, stack_states(states))
        # unstack live slots only; pad slots are discarded
        for i, t in enumerate(tenants):
            t.state = unstack_state(state_b, i)
        return host_metrics(metrics_b, n), n_pad
