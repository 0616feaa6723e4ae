"""What ``solve(spec)`` returns (port of ``repro.api.report``, full-participation part)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """Metrics of one communication round."""

    round: int
    grad_norm: float | None = None
    f: float | None = None
    l: float | None = None
    sent_elems: int | None = None  # payload elements uplinked this round
    sent_bits: int = 0  # under the spec's accounting model
    sent_bits_payload: int | None = None  # Section-7 payload model
    sent_bits_wire: int | None = None  # full framed uplink model


@dataclasses.dataclass
class RunReport:
    """Final model, per-round records and timings of one run."""

    spec: Any
    algorithm: str
    backend: str
    x: np.ndarray
    records: list[RoundRecord]
    rounds: int
    wall_time_s: float
    init_time_s: float
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def _column(self, name: str) -> np.ndarray:
        return np.asarray([getattr(r, name) for r in self.records])

    @property
    def grad_norms(self) -> np.ndarray:
        return self._column("grad_norm")

    @property
    def f_vals(self) -> np.ndarray:
        return self._column("f")

    @property
    def l_vals(self) -> np.ndarray:
        return self._column("l")

    @property
    def sent_bits(self) -> np.ndarray:
        return self._column("sent_bits")

    @property
    def sent_bits_payload(self) -> np.ndarray:
        return self._column("sent_bits_payload")

    @property
    def sent_bits_wire(self) -> np.ndarray:
        return self._column("sent_bits_wire")

    def summary(self) -> str:
        """One-line human summary (what the CLI prints)."""
        gn = (
            f"||grad||={self.records[-1].grad_norm:.3e}"
            if self.records
            else "||grad||=n/a"
        )
        mb = float(np.sum(self.sent_bits)) / 8e6 if self.records else 0.0
        return (
            f"{self.algorithm}@{self.backend}[{self.extras.get('device', '?')}]: "
            f"rounds={self.rounds} {gn} uplink={mb:.2f} MB ({self.spec.accounting}) "
            f"solve={self.wall_time_s:.2f}s init={self.init_time_s:.2f}s"
        )
