"""Memory-pressure management: spilling tenants to FNLS1 checkpoints (port of
``repro.serve_fednl.spill``).

A spilled tenant is written as an ordinary FNLS1 session checkpoint -- the
SAME format :meth:`repro_torch.api.session.Session.save` produces, byte for
byte the reference's -- so a spilled file is not an engine-private
artifact: ``open_session(spec, restore=path)`` resumes it outside the
engine, ``FedNLServer.resume(path)`` re-admits it, and the reference's
engine reads it too.  Batched and solo tenants converge on the format from
opposite directions:

* a **solo** tenant spills through ``session.save(path)`` + ``close()``
  (closing also tears down wire transports -- a star-tcp tenant's client
  fleet is released the moment it spills, never leaked);
* a **batch** tenant's algorithm state is wrapped in a
  :class:`~repro_torch.api.session.SessionState` with the *local-backend
  layout* (``meta={"kind": ...}``, arrays under ``state.*``,
  ``backend="local"``) -- what the local session handle's ``snapshot()``
  makes -- so restore goes through the same ``algo.init`` +
  ``restored_state`` path the local handle uses.

A tenant's new spill supersedes the file of its previous spill (the one it
was resumed from), which is deleted once the new file is written
(``save_state`` writes atomically, so a process killed mid-spill leaves
the previous file whole and no file under the new name): the newest
checkpoint of every spilled or resumed tenant stays on disk, and the
directory holds one file per tenant, not one per spill (the reference keeps
every file until shutdown: at w8a's shape a file is 52 MB, and an engine
under pressure spills a few tenants a tick).

Victim selection implements two policies over the resident set:
``"lru"`` spills the least-recently-advanced tenant first (admission-order
tiebreak -> round-robin time-slicing when everyone advances every tick);
``"cost"`` spills the largest resident state first (packed Hessian ~d^2),
freeing the most memory per spill.
"""

from __future__ import annotations

import pathlib
import tempfile

from repro_torch.api.backends import state_arrays
from repro_torch.api.session import SessionState, save_state
from repro_torch.serve_fednl.tenant import RUNNING, SPILLED, Tenant


class SpillManager:
    """Owns the spill directory and the spill/victim mechanics."""

    def __init__(self, spill_dir=None, policy: str = "lru"):
        if policy not in ("lru", "cost"):
            raise ValueError(f"eviction policy must be 'lru' or 'cost', got {policy!r}")
        self.policy = policy
        self._tmp = None
        if spill_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="fednl-serve-")
            spill_dir = self._tmp.name
        self.dir = pathlib.Path(spill_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.spill_count = 0
        self.resume_count = 0

    def path_for(self, tenant: Tenant) -> pathlib.Path:
        return self.dir / f"{tenant.tenant_id}.r{tenant.round}.fnlsess"

    def pick_victims(self, resident: list[Tenant], n: int, current_tick: int) -> list[Tenant]:
        """Choose up to ``n`` spill victims from ``resident``.  Tenants
        admitted or resumed on the current tick are exempt (no thrashing a
        tenant back out before it has advanced a single round)."""
        candidates = [t for t in resident if t.status == RUNNING and t.admitted_tick < current_tick]
        if self.policy == "cost":
            candidates.sort(key=lambda t: (-t.cost, t.last_active_tick))
        else:  # lru
            candidates.sort(key=lambda t: (t.last_active_tick, t.admitted_tick))
        return candidates[:n]

    def spill(self, tenant: Tenant) -> pathlib.Path:
        """Write ``tenant`` to disk, drop its resident state and delete the
        file of its previous spill, which this one supersedes."""
        path = self.path_for(tenant)
        previous = tenant.spill_path
        if tenant.lane == "solo":
            tenant.session.save(path)
            tenant.session.close()  # releases wire transports too
            tenant.session = None
        else:
            save_state(
                SessionState(
                    spec=tenant.spec,
                    algorithm=tenant.algo.name,
                    backend="local",
                    round=tenant.round,
                    meta={"kind": tenant.algo.kind},
                    arrays=state_arrays(tenant.state),
                    records=tuple(tenant.records),
                ),
                path,
            )
            tenant.state = None
        if previous is not None and previous != path and previous.parent == self.dir:
            previous.unlink(missing_ok=True)
        tenant.spill_path = path
        tenant.status = SPILLED
        tenant.spill_count += 1
        self.spill_count += 1
        return path

    def cleanup(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
