"""What ``solve(spec)`` and ``solve_many`` return (port of ``repro.api.report``).

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
    dropped: tuple[int, ...] | None = None  # PP: clients that dropped (none at local)


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

    @property
    def dropped(self) -> list[list[int]]:
        return [list(r.dropped or ()) for r in self.records]

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


class RunReportBuilder:
    """Incremental :class:`RunReport` construction (the Session path).

    Records come in chunks (``extend``); ``build`` snapshots the records so far with the current tail (final
    model, extras, the PP grad diagnostic), so a session can report mid-run
    and keep stepping without changing a report already built.
    """

    def __init__(self, spec: Any, algorithm: str, backend: str):
        self.spec = spec
        self.algorithm = algorithm
        self.backend = backend
        self.records: list[RoundRecord] = []

    def extend(self, records: list[RoundRecord]) -> list[RoundRecord]:
        self.records.extend(records)
        return records

    def build(
        self,
        x: np.ndarray,
        wall_time_s: float,
        init_time_s: float,
        final_grad_norm_fn: Callable[[], float] | None = None,
        extras: dict[str, Any] | None = None,
        spec: Any = None,
    ) -> RunReport:
        """A report of the records so far; ``spec`` relabels it (the sweep's
        warm-start plan reports each rounds-prefix spec from one session)."""
        return RunReport(
            spec=self.spec if spec is None else spec,
            algorithm=self.algorithm,
            backend=self.backend,
            x=np.asarray(x),
            records=list(self.records),
            rounds=len(self.records),
            wall_time_s=wall_time_s,
            init_time_s=init_time_s,
            final_grad_norm_fn=final_grad_norm_fn,
            extras=dict(extras) if extras else {},
        )


def _spec_get(spec: Any, path: str) -> Any:
    """Resolve a dotted field path on a spec ('compressor.name', 'data.seed')."""
    value = spec
    for part in path.split("."):
        value = getattr(value, part)
    return value


@dataclasses.dataclass
class SweepReport:
    """What ``solve_many`` returns: one RunReport per spec in expansion
    order, the engine's log of every grouping and fallback decision, and
    aggregation helpers."""

    specs: tuple[Any, ...]
    reports: list[RunReport]
    log: list[str]
    wall_time_s: float
    sweep: Any = None  # the SweepSpec, when solve_many was given one
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.reports)

    def __iter__(self):
        return iter(self.reports)

    def __getitem__(self, i: int) -> RunReport:
        return self.reports[i]

    def group_by(self, *fields: str) -> dict[tuple, list[RunReport]]:
        """Reports grouped by spec field paths, in expansion order within a
        group: ``report.group_by("compressor.name")``."""
        out: dict[tuple, list[RunReport]] = {}
        for spec, rep in zip(self.specs, self.reports):
            out.setdefault(tuple(_spec_get(spec, f) for f in fields), []).append(rep)
        return out

    def table(self, *fields: str) -> list[dict[str, Any]]:
        """One summary row per spec: the requested spec fields, rounds, the
        last grad norm (full participation), total uplink bits, wall time."""
        rows = []
        for spec, rep in zip(self.specs, self.reports):
            row: dict[str, Any] = {f: _spec_get(spec, f) for f in fields}
            last = rep.records[-1] if rep.records else None
            row.update(
                rounds=rep.rounds,
                grad_norm=(last.grad_norm if last is not None else None),
                sent_bits_total=int(np.sum(rep.sent_bits)) if rep.records else 0,
                wall_time_s=rep.wall_time_s,
            )
            rows.append(row)
        return rows

    def round_table(self, column: str) -> np.ndarray:
        """(n_specs, max_rounds) table of one per-round metric; shorter runs
        are padded with NaN."""
        width = max((rep.rounds for rep in self.reports), default=0)
        out = np.full((len(self.reports), width), np.nan)
        for i, rep in enumerate(self.reports):
            vals = [getattr(r, column) for r in rep.records]
            out[i, : len(vals)] = [np.nan if v is None else float(v) for v in vals]
        return out

    def summary(self) -> str:
        batched = self.extras.get("batched_specs", 0)
        return (
            f"sweep: {len(self.reports)} specs in {self.wall_time_s:.2f}s "
            f"({len(self.reports) / self.wall_time_s:.1f} specs/s; "
            f"{batched} batched, {len(self.reports) - batched} fallback, "
            f"{self.extras.get('n_groups', 0)} groups)"
            if self.wall_time_s > 0
            else f"sweep: {len(self.reports)} specs"
        )
