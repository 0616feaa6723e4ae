"""Declarative experiment description (port of ``repro.api.spec``).

Every field of ``repro``'s ``ExperimentSpec``, with the same names, defaults
and checks, so that a spec -- and an FNLS1 checkpoint, which carries one --
crosses between the packages; ``topology`` and ``membership`` take the
port's ``TopologySpec`` and ``MembershipSpec`` (``repro_torch.comm.topology``).
Fields the port cannot run yet are accepted here and refused by
``check_spec`` (``solve``, ``open_session``, ``solve_many``) with the
ROADMAP item that ports them: ``aggregate``, ``devices`` and the
``sharded`` backend (A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.accounting import ACCOUNTINGS
from repro_torch.comm.transport import FaultSpec


def _algorithm_kind(name: str) -> str | None:
    """Registered ``Algorithm.kind`` ("full" | "pp"), or None when unknown
    (the unknown name is refused by ``solve``, with the registry's error)."""
    from repro_torch.api.registry import ALGORITHMS

    try:
        return ALGORITHMS.get(name).kind
    except KeyError:
        return None


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

    def dims(self) -> tuple[int, int, int]:
        """(d, n_clients, n_i) of the problem this spec builds."""
        if self.libsvm is not None:
            if self.clients is None or self.per_client is None:
                raise ValueError("libsvm data needs clients and per_client")
            from repro_torch.data import parse_libsvm

            x, _ = parse_libsvm(self.libsvm)
            return x.shape[1] + 1, self.clients, self.per_client
        if self.shape is not None:
            return tuple(self.shape)
        from repro_torch.data import DATASET_SHAPES

        return DATASET_SHAPES[self.dataset]

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
    """One declarative FedNL experiment: ``solve(spec)`` runs it.

    Backends: ``local`` (the port's single-process simulation),
    ``star-loopback`` and ``star-tcp`` (the wire protocol); ``sharded`` is
    registered and refused until it is ported.  Algorithms: fednl / fednl-ls
    / fednl-pp.
    """

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
    # the reference's Hessian SYRK routing: "fused" and "pallas" both run the
    # port's one Hessian kernel (the SYRK kernel, its plain version on the
    # CPU); "jnp", the reference's XLA-only parity path, is refused at solve
    hessian: str = "fused"
    use_kernel: bool = False  # deprecated spelling of hessian="pallas"
    # line-search parameters (fednl-ls)
    ls_c: float = 0.49
    ls_gamma: float = 0.5
    ls_max_steps: int = 30
    ls_tol: float = 1e-12

    # --- participation (fednl-pp) ---------------------------------------
    tau: int | None = None  # sampled clients per round (None -> n // 2)
    on_dropout: str = "partial"  # "partial" | "resample" master fallback
    fault: FaultSpec | None = None  # dropout/straggler injection

    # --- topology + membership (repro_torch.comm.topology) ---------------
    # how uplinks reach the root: None/star = the flat star; a tree inserts
    # aggregators; mode="async" bounds staleness instead of a barrier
    topology: "TopologySpec | None" = None
    # a join/leave schedule (flat sync star, wire backends only)
    membership: "MembershipSpec | None" = None

    # --- accounting + execution backend ---------------------------------
    accounting: str = "payload"
    backend: str = "local"
    aggregate: str = "dense_psum"  # sharded collective (A13)
    devices: int | None = None  # sharded mesh size (A13)
    host: str = "127.0.0.1"  # star-tcp bind address

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
        if self.hessian not in ("fused", "jnp", "pallas"):
            raise ValueError(
                f"unknown hessian {self.hessian!r}; use 'fused' | 'jnp' | 'pallas'"
            )
        if self.on_dropout not in ("partial", "resample"):
            raise ValueError(f"unknown on_dropout {self.on_dropout!r}")
        if self.rounds < 0:
            raise ValueError("rounds must be >= 0")
        kind = _algorithm_kind(self.algorithm)
        if kind == "full" and (self.tau is not None or self.fault is not None):
            raise ValueError(
                f"tau/fault only apply to partial participation, not {self.algorithm!r}"
            )
        if kind == "pp" and self.tol > 0.0:
            raise ValueError(
                "tol-based early stopping is undefined for partial "
                "participation (the server never sees the global gradient); "
                "bound the run with rounds instead"
            )
        if self.topology is not None or self.membership is not None:
            from repro_torch.comm.topology import MembershipSpec, TopologySpec

            if self.topology is not None and not isinstance(self.topology, TopologySpec):
                raise TypeError(
                    f"topology must be a TopologySpec, got {type(self.topology).__name__}"
                )
            if self.membership is not None and not isinstance(self.membership, MembershipSpec):
                raise TypeError(
                    f"membership must be a MembershipSpec, got {type(self.membership).__name__}"
                )
            topo_live = self.topology is not None and not self.topology.trivial
            mem_live = self.membership is not None and not self.membership.trivial
            if topo_live and mem_live:
                raise ValueError(
                    "membership events compose with the flat sync star only "
                    "(drop the non-trivial topology or the membership events)"
                )
            if (topo_live or mem_live) and kind == "pp":
                raise ValueError(
                    f"topology/membership do not compose with partial "
                    f"participation ({self.algorithm!r}): PP samples a "
                    "cohort per round already — spec one participation "
                    "model at a time"
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

    @property
    def hessian_impl(self) -> str:
        """Effective Hessian routing (``use_kernel`` back-compat)."""
        return "pallas" if self.use_kernel else self.hessian

    def tau_for(self, n_clients: int) -> int:
        """The participation size (default: half the clients)."""
        tau = self.tau if self.tau is not None else max(1, n_clients // 2)
        if not 0 < tau <= n_clients:
            raise ValueError(f"need 0 < tau <= n, got tau={tau}, n={n_clients}")
        return tau

    def replace(self, **changes: Any) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)

    # fields a restored session may change: run control.  Everything else
    # shapes the checkpointed state or the trajectory and must match it.
    RESTORE_VARIABLE_FIELDS = frozenset({"rounds", "tol", "host"})

    def check_restore_from(self, saved: "ExperimentSpec") -> None:
        """Refuse a checkpoint of another experiment, naming each field that
        differs (nested specs by their subfield, "compressor.name") and both
        values.  Only :data:`RESTORE_VARIABLE_FIELDS` may differ."""

        def diff(mine, theirs, prefix=""):
            out = []
            for f in dataclasses.fields(mine):
                name = f"{prefix}{f.name}"
                if not prefix and f.name in self.RESTORE_VARIABLE_FIELDS:
                    continue
                a, b = getattr(mine, f.name), getattr(theirs, f.name)
                if a == b:
                    continue
                if dataclasses.is_dataclass(a) and not isinstance(a, type) and type(a) is type(b):
                    out.extend(diff(a, b, prefix=f"{name}."))
                else:
                    out.append(name)
            return out

        def resolve(obj, dotted):
            for part in dotted.split("."):
                obj = getattr(obj, part)
            return obj

        mismatched = diff(self, saved)
        if mismatched:
            detail = "; ".join(
                f"{name}: checkpoint ran with {resolve(saved, name)!r}, "
                f"spec asks for {resolve(self, name)!r}"
                for name in mismatched
            )
            raise ValueError(
                f"spec is incompatible with the checkpoint it restores "
                f"({detail}).  A checkpoint resumes the same experiment — "
                f"only {sorted(self.RESTORE_VARIABLE_FIELDS)} may change on "
                f"restore; to vary {', '.join(mismatched)}, start a fresh "
                f"run (open_session / solve without restore)"
            )

    def grid(self, *, batch: str = "auto", **axes: Any):
        """Expand this spec into a :class:`repro_torch.api.SweepSpec`:
        ``spec.grid(seed=range(4), compressor=["topk", "randk"])``.  Axis
        names are ExperimentSpec fields plus the nested aliases
        (``compressor`` by name, ``k_multiplier``, ``dataset``, ``data_seed``,
        ...)."""
        from repro_torch.api.sweep import grid as _grid

        return _grid(self, batch=batch, **axes)
