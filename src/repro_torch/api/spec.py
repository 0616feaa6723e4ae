"""Declarative experiment description (port of ``repro.api.spec``).

The fields are the ones the local backend's three algorithms read
(``fednl``, ``fednl-ls``, ``fednl-pp``), with the same names, defaults and
checks as ``repro``'s spec; :func:`repro_torch.api.solve` runs it.  Other
backends are accepted here and refused by ``solve`` until they are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.accounting import ACCOUNTINGS

# each algorithm's participation model: "full" (every client every round)
# or "pp" (tau clients a round)
ALGORITHM_KINDS = {"fednl": "full", "fednl-ls": "full", "fednl-pp": "pp"}


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
    mu: float = 1e-3  # strong-convexity lower bound for Option A
    hess0: str = "exact"
    # line-search parameters (fednl-ls)
    ls_c: float = 0.49
    ls_gamma: float = 0.5
    ls_max_steps: int = 30
    ls_tol: float = 1e-12

    # --- participation (fednl-pp) ---------------------------------------
    tau: int | None = None  # sampled clients per round (None -> n // 2)

    # --- accounting + execution backend ---------------------------------
    accounting: str = "payload"
    backend: str = "local"

    # --- run control -----------------------------------------------------
    rounds: int = 100
    # grad-norm early stop (0 = run all rounds); full participation only:
    # the PP server never sees the global gradient
    tol: float = 0.0
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
        kind = ALGORITHM_KINDS.get(self.algorithm)  # unknown: refused by solve
        if kind == "full" and self.tau is not None:
            raise ValueError(
                f"tau only applies to partial participation, not {self.algorithm!r}"
            )
        if kind == "pp" and self.tol > 0.0:
            raise ValueError(
                "tol-based early stopping is undefined for partial "
                "participation (the server never sees the global gradient); "
                "bound the run with rounds instead"
            )

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
            ls_c=self.ls_c,
            ls_gamma=self.ls_gamma,
            ls_max_steps=self.ls_max_steps,
            ls_tol=self.ls_tol,
            accounting=self.accounting,
        )

    def tau_for(self, n_clients: int) -> int:
        """The participation size (default: half the clients)."""
        tau = self.tau if self.tau is not None else max(1, n_clients // 2)
        if not 0 < tau <= n_clients:
            raise ValueError(f"need 0 < tau <= n, got tau={tau}, n={n_clients}")
        return tau

    def replace(self, **changes: Any) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)
