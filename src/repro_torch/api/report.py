"""What ``solve(spec)`` returns (port of ``repro.api.report``).

Fields an algorithm does not expose are ``None``: FedNL-PP never computes
the global gradient in a round, so its records carry the model ``x`` and
the participants instead, and ``final_grad_norm`` is one diagnostic after
the run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """Metrics of one communication round."""

    round: int
    grad_norm: float | None = None  # None for PP (the server never sees it)
    f: float | None = None
    l: float | None = None
    sent_elems: int | None = None  # payload elements uplinked this round
    sent_bits: int = 0  # under the spec's accounting model
    sent_bits_payload: int | None = None  # Section-7 payload model
    sent_bits_wire: int | None = None  # full framed uplink model
    ls_steps: int | None = None  # fednl-ls backtracking steps
    x: np.ndarray | None = None  # PP: the model the server produced this round
    participants: tuple[int, ...] | None = None  # PP: the clients chosen (idx)


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
    # PP only: the post-run ||grad f(x)|| diagnostic, evaluated on first access
    final_grad_norm_fn: Callable[[], float] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def final_grad_norm(self) -> float | None:
        """Post-run ||grad f(x)||: the last recorded grad norm for full
        participation, the (cached) diagnostic for PP."""
        if "_final_grad_norm" not in self.__dict__:
            if self.final_grad_norm_fn is not None:
                self._final_grad_norm = float(self.final_grad_norm_fn())
                self.final_grad_norm_fn = None  # its closure holds the problem data
            elif self.records and self.records[-1].grad_norm is not None:
                self._final_grad_norm = self.records[-1].grad_norm
            else:
                self._final_grad_norm = None
        return self._final_grad_norm

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

    @property
    def ls_steps(self) -> np.ndarray:
        return self._column("ls_steps")

    @property
    def x_hist(self) -> np.ndarray:
        """(rounds, d) per-round models (PP)."""
        return np.asarray([r.x for r in self.records])

    @property
    def participants(self) -> list[list[int]]:
        return [list(r.participants or ()) for r in self.records]

    def summary(self) -> str:
        """One-line human summary (what the CLI prints)."""
        gn_cached = self.__dict__.get("_final_grad_norm")
        gn = (
            f"||grad||={self.records[-1].grad_norm:.3e}"
            if self.records and self.records[-1].grad_norm is not None
            else f"||grad(x_final)||={gn_cached:.3e}"
            if gn_cached is not None
            else "||grad||=n/a"
        )
        mb = float(np.sum(self.sent_bits)) / 8e6 if self.records else 0.0
        return (
            f"{self.algorithm}@{self.backend}[{self.extras.get('device', '?')}]: "
            f"rounds={self.rounds} {gn} uplink={mb:.2f} MB ({self.spec.accounting}) "
            f"solve={self.wall_time_s:.2f}s init={self.init_time_s:.2f}s"
        )
