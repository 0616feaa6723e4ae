"""Declarative experiment description (port of ``repro.api.spec``).

The fields are the ones the local ``fednl`` path reads, with the same names
and defaults as ``repro``'s spec; :func:`repro_torch.api.solve` runs it.
Other algorithms and backends are accepted here and refused by ``solve``
until they are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.accounting import ACCOUNTINGS


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Where the federated problem comes from: a named synthetic shape
    (``repro_torch.data.DATASET_SHAPES``), an explicit ``(d, n_clients, n_i)``
    ``shape``, or a LIBSVM file partitioned into ``clients`` x ``per_client``.
    ``seed`` drives the generator and the u.a.r. reshuffle."""

    dataset: str = "tiny"
    shape: tuple[int, int, int] | None = None
    libsvm: str | None = None
    clients: int | None = None
    per_client: int | None = None
    seed: int = 0

    def build(self):
        """z: (n_clients, n_i, d) label-absorbed design matrices, as numpy."""
        from repro_torch.data import (
            DATASET_SHAPES,
            add_intercept,
            make_synthetic_logreg,
            parse_libsvm,
            partition_clients,
        )

        if self.libsvm is not None:
            if self.clients is None or self.per_client is None:
                raise ValueError("libsvm data needs clients and per_client")
            x, y = parse_libsvm(self.libsvm)
            n, n_i = self.clients, self.per_client
        else:
            name_or_dims = self.shape if self.shape is not None else self.dataset
            if isinstance(name_or_dims, str):
                _, n, n_i = DATASET_SHAPES[name_or_dims]
            else:
                _, n, n_i = name_or_dims
            x, y = make_synthetic_logreg(name_or_dims, seed=self.seed)
        return partition_clients(add_intercept(x), y, n, n_i, seed=self.seed)


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """Which compressor a spec runs: ``name``, the paper's K = k_multiplier * d
    budget, and an optional Hessian learning rate override."""

    name: str = "topk"
    k_multiplier: float = 8.0
    alpha: float | None = None


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One declarative FedNL experiment."""

    # --- objective -------------------------------------------------------
    objective: str = "logreg"
    lam: float = 1e-3
    data: DataSpec = dataclasses.field(default_factory=DataSpec)

    # --- algorithm -------------------------------------------------------
    algorithm: str = "fednl"
    compressor: CompressorSpec = dataclasses.field(default_factory=CompressorSpec)
    option: str = "B"
    mu: float = 1e-3
    hess0: str = "exact"

    # --- accounting + execution backend ---------------------------------
    accounting: str = "payload"
    backend: str = "local"

    # --- run control -----------------------------------------------------
    rounds: int = 100
    tol: float = 0.0  # grad-norm early stop (0 = run all rounds)
    seed: int = 0

    def __post_init__(self):
        if self.objective != "logreg":
            raise ValueError(
                f"unknown objective {self.objective!r}; only 'logreg' is implemented"
            )
        if self.accounting not in ACCOUNTINGS:
            raise ValueError(
                f"unknown accounting {self.accounting!r}; use {' | '.join(ACCOUNTINGS)}"
            )
        if self.option not in ("A", "B"):
            raise ValueError(f"unknown option {self.option!r}; use 'A' | 'B'")
        if self.hess0 not in ("exact", "zero"):
            raise ValueError(f"unknown hess0 {self.hess0!r}")
        if self.rounds < 0:
            raise ValueError("rounds must be >= 0")

    def fednl_config(self):
        """Project onto :class:`repro_torch.core.fednl.FedNLConfig`."""
        from repro_torch.core.fednl import FedNLConfig

        return FedNLConfig(
            compressor=self.compressor.name,
            k_multiplier=self.compressor.k_multiplier,
            alpha=self.compressor.alpha,
            option=self.option,
            mu=self.mu,
            lam=self.lam,
            hess0=self.hess0,
            accounting=self.accounting,
        )

    def replace(self, **changes: Any) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)
