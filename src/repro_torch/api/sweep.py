"""Declarative experiment sweeps: SweepSpec = base spec + axes (port of
``repro.api.sweep``).

A sweep is data, exactly like :class:`repro_torch.api.ExperimentSpec`: a
frozen base spec plus an ordered tuple of (axis, values) pairs.  Expansion is
the cartesian product in declared order -- deterministic, duplicate-free, and
validated through the same ``ExperimentSpec.__post_init__`` / registry
machinery as a hand-built spec, so an invalid axis value fails with exactly
the error ``solve()`` would raise.

``ExperimentSpec.grid(**axes)`` is the ergonomic constructor::

    sweep = ExperimentSpec(data=DataSpec(dataset="w8a")).grid(
        seed=range(4),
        compressor=["topk", "randseqk", "natural"],
    )
    report = solve_many(sweep)          # one batched group per shape

Axis names are ExperimentSpec field names, plus aliases that reach into the
nested specs (``compressor`` accepts bare names, ``k_multiplier`` /
``comp_alpha`` target the CompressorSpec, ``data`` / ``dataset`` /
``data_seed`` target the DataSpec).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator

from repro_torch.api.spec import CompressorSpec, DataSpec, ExperimentSpec

BATCH_MODES = ("auto", "vmap", "never")

_SPEC_FIELDS = {f.name for f in dataclasses.fields(ExperimentSpec)}


def _set_compressor(spec: ExperimentSpec, value: Any) -> ExperimentSpec:
    """Compressor axis: a bare name keeps the base k_multiplier/alpha."""
    if isinstance(value, CompressorSpec):
        return spec.replace(compressor=value)
    if isinstance(value, str):
        return spec.replace(
            compressor=dataclasses.replace(spec.compressor, name=value)
        )
    raise TypeError(
        f"compressor axis values must be str or CompressorSpec, got {value!r}"
    )


def _set_data(spec: ExperimentSpec, value: Any) -> ExperimentSpec:
    if not isinstance(value, DataSpec):
        raise TypeError(f"data axis values must be DataSpec, got {value!r}")
    return spec.replace(data=value)


# axis aliases that reach into the nested frozen specs
_NESTED_AXES = {
    "compressor": _set_compressor,
    "data": _set_data,
    "k_multiplier": lambda s, v: s.replace(
        compressor=dataclasses.replace(s.compressor, k_multiplier=float(v))
    ),
    "comp_alpha": lambda s, v: s.replace(
        compressor=dataclasses.replace(s.compressor, alpha=v)
    ),
    "dataset": lambda s, v: s.replace(
        data=dataclasses.replace(s.data, dataset=str(v), shape=None)
    ),
    "data_seed": lambda s, v: s.replace(
        data=dataclasses.replace(s.data, seed=int(v))
    ),
}


def _apply_axis(spec: ExperimentSpec, name: str, value: Any) -> ExperimentSpec:
    if name in _NESTED_AXES:
        return _NESTED_AXES[name](spec, value)
    return spec.replace(**{name: value})


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A frozen grid of experiments: base spec x cartesian axes.

    ``batch`` is the execution policy ``solve_many`` follows:
      auto   group compatible specs and run each group's rounds over all its
             specs at once, each kernel launched once a round for the group,
             the matrix-vector products one per spec (bit-identical to
             sequential ``solve()`` on the CPU); everything else runs per
             spec -- logged, never silently dropped.
      vmap   like auto, but the groups may span datasets of one shape and the
             matrix-vector products batch over the specs (one GEMM): fewer
             launches and fewer reads of the data, at the price of ulp-level
             divergence from the sequential path.
      never  run every spec sequentially through ``solve()`` in expansion
             order (per-spec timing stays meaningful; also disables the
             warm-started session reuse of rounds-prefix fallback groups,
             see ``repro_torch.api.batch``).
    """

    base: ExperimentSpec
    axes: tuple[tuple[str, tuple[Any, ...]], ...] = ()
    batch: str = "auto"

    def __post_init__(self):
        if self.batch not in BATCH_MODES:
            raise ValueError(
                f"unknown batch mode {self.batch!r}; use "
                f"{' | '.join(BATCH_MODES)}"
            )
        # normalize: tolerate lists/iterators from callers, store tuples
        object.__setattr__(
            self,
            "axes",
            tuple((name, tuple(values)) for name, values in self.axes),
        )
        seen_axes = set()
        for name, values in self.axes:
            if name not in _SPEC_FIELDS and name not in _NESTED_AXES:
                known = sorted(_SPEC_FIELDS | set(_NESTED_AXES))
                raise ValueError(
                    f"unknown sweep axis {name!r}; axes are ExperimentSpec "
                    f"fields or aliases: {', '.join(known)}"
                )
            if name in seen_axes:
                raise ValueError(f"duplicate sweep axis {name!r}")
            seen_axes.add(name)
            if not values:
                raise ValueError(f"sweep axis {name!r} has no values")
            if len(set(values)) != len(values):
                raise ValueError(
                    f"sweep axis {name!r} has duplicate values: {values!r}"
                )

    @property
    def n_specs(self) -> int:
        n = 1
        for _, values in self.axes:
            n *= len(values)
        return n

    def specs(self) -> tuple[ExperimentSpec, ...]:
        """Deterministic expansion: cartesian product, axes in declared order,
        values in given order (later axes vary fastest).  Each spec runs the
        full ``ExperimentSpec`` validation, so a bad combination fails here
        with the same error ``solve()`` raises on a hand-built spec."""
        out = []
        names = [name for name, _ in self.axes]
        for combo in itertools.product(*(values for _, values in self.axes)):
            spec = self.base
            for name, value in zip(names, combo):
                spec = _apply_axis(spec, name, value)
            out.append(spec)
        if len(set(out)) != len(out):
            # distinct axis values can still collide after normalization
            # (e.g. "topk" and CompressorSpec("topk") on the same axis)
            raise ValueError("sweep axes expand to duplicate specs")
        return tuple(out)

    def __iter__(self) -> Iterator[ExperimentSpec]:
        return iter(self.specs())

    def __len__(self) -> int:
        return self.n_specs

    def replace(self, **changes: Any) -> "SweepSpec":
        return dataclasses.replace(self, **changes)


def grid(base: ExperimentSpec, *, batch: str = "auto", **axes: Any) -> SweepSpec:
    """Build a :class:`SweepSpec` from keyword axes (``ExperimentSpec.grid``
    delegates here).  Axis order follows keyword order."""
    return SweepSpec(
        base=base,
        axes=tuple((name, tuple(values)) for name, values in axes.items()),
        batch=batch,
    )
