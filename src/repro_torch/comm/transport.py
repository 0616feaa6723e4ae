"""The fault model of a FedNL-PP run (port of ``repro.comm.transport.FaultSpec``).

Only the spec is ported: it is a field of ``ExperimentSpec`` and rides in
FNLS1 checkpoints, which both packages read.  The transports that inject
the faults (loopback, TCP) are the wire stack, not ported yet (ROADMAP
A11), so a spec with a fault is refused when it is run.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-client fault model for partial-participation runs.

    ``drop_prob``: probability a chosen client drops the round.
    ``straggler_prob`` / ``straggler_delay_s``: probability and duration of a
    stall before the reply.  ``seed`` seeds the clients' fault draws.
    """

    drop_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_delay_s: float = 0.0
    seed: int = 0

    @property
    def active(self) -> bool:
        return self.drop_prob > 0.0 or self.straggler_prob > 0.0
