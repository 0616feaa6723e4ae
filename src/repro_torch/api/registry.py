"""Pluggable strategy registries: algorithm x backend x compressor
(port of ``repro.api.registry``).

  * :func:`register_algorithm` -- an :class:`Algorithm` bundles the state
    init and round builder the local backend drives, the optional batched
    round the sweep engine drives, and the capability flags;
  * :func:`register_backend` -- a :class:`Backend` strategy turns
    ``(spec, algorithm, problem)`` into a session handle or a report;
  * :func:`register_compressor` -- adds a ``(T, k) -> Compressor`` factory
    to the port's compressor registry.

Built-ins register themselves on first lookup (``repro_torch.api.backends``),
so ``import repro_torch.api`` stays cheap and free of cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A registered FedNL-family algorithm.

    ``kind``: "full" (every round reports grad norm, f, l -- Algorithms 1/2)
    or "pp" (partial participation: rounds report x and l -- Algorithm 3).

    ``init(z, cfg, x0, seed) -> state`` and ``make_round(z, cfg, tau) ->
    round_fn`` are what the local backend drives (``tau`` is ignored by
    "full" algorithms).

    ``make_batch_round(z, cfg, comps, comp_idx, alpha, vectorize) ->
    round_fn`` is the optional sweep hook: a round over S specs stacked on a
    leading axis, each running the compressor ``comps[comp_idx[s]]`` under
    the group's shared config and Hessian learning rate
    (``repro_torch.core.fednl_batch``).  Algorithms without it always take
    the per-spec path in a sweep.
    """

    name: str
    kind: str  # "full" | "pp"
    init: Callable
    make_round: Callable
    line_search: bool = False
    make_batch_round: Callable | None = None

    def __post_init__(self):
        if self.kind not in ("full", "pp"):
            raise ValueError(f"unknown algorithm kind {self.kind!r}")


class SessionHandle:
    """Round-granular driver of one live run, returned by :meth:`Backend.open`
    and driven by ``repro_torch.api.session.Session``.

    Contract: ``step_rounds(k)`` then ``step_rounds(m)`` gives the same
    state and records, bit for bit, as ``step_rounds(k + m)``: a backend
    may run each call as one chunk with one host sync at its end, but the
    chunking never shapes the trajectory.
    """

    #: rounds executed so far (a restored handle starts at the checkpoint's)
    round: int = 0
    #: seconds spent building and warming up before the first round
    init_time_s: float = 0.0
    #: cumulative seconds spent inside step_rounds
    wall_time_s: float = 0.0

    def step_rounds(self, n: int) -> list:
        """Advance ``n`` rounds; return one RoundRecord per round."""
        raise NotImplementedError

    def snapshot(self) -> tuple[dict, dict]:
        """``(meta, arrays)``: JSON-able scalars and name -> numpy array,
        everything needed to resume bit for bit (the records live in the
        Session)."""
        raise NotImplementedError

    def finalize(self) -> dict:
        """Report tail for the current state: ``{"x": ndarray}`` plus
        optional ``"extras"`` / ``"final_grad_norm_fn"``.  Callable
        repeatedly without advancing the state."""
        raise NotImplementedError

    def close(self) -> None:
        """Release what the handle holds.  Idempotent."""


class Backend:
    """Execution-strategy interface.

    Subclasses implement :meth:`open` (with ``supports_sessions = True``) or
    the run-to-completion :meth:`run`; ``supports`` says which algorithms
    the backend can run.
    """

    name: str = "?"
    needs_problem: bool = True
    supports_faults: bool = False  # transport-level dropout/straggler injection
    supports_x0: bool = False  # accepts an initial-iterate override
    supports_sessions: bool = False  # implements open() -> SessionHandle
    supports_topology: bool = False  # non-trivial topology / membership

    def supports(self, algo: Algorithm) -> bool:
        return True

    def open(self, spec, algo: Algorithm, z, x0, restore=None, device=None) -> SessionHandle:
        raise NotImplementedError(
            f"backend {self.name!r} does not implement the Session protocol "
            "(open); use solve(spec) / Backend.run"
        )

    def run(self, spec, algo: Algorithm, z, x0, device=None):
        """Run to completion: open -> run -> close for session backends."""
        if not self.supports_sessions:
            raise NotImplementedError
        from repro_torch.api.session import Session

        with Session(spec, algo, self, self.open(spec, algo, z, x0, device=device)) as s:
            return s.run()


class Registry:
    """A named string -> strategy map with lazy built-in population."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, object] = {}

    def register(self, name: str, entry, *, overwrite: bool = False) -> None:
        # built-ins first, so a user registration always layers on top of them
        _ensure_builtins()
        if not overwrite and name in self._entries:
            raise ValueError(f"{self.kind} {name!r} already registered")
        self._entries[name] = entry

    def get(self, name: str):
        _ensure_builtins()
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self) -> list[str]:
        _ensure_builtins()
        return sorted(self._entries)


ALGORITHMS = Registry("algorithm")
BACKENDS = Registry("backend")

_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        # set before the import as a re-entrancy guard (backends.py registers
        # at module level); on failure reset it and roll back the partial
        # registrations, so that a retry re-runs the module cleanly
        _builtins_loaded = True
        before = {r: set(r._entries) for r in (ALGORITHMS, BACKENDS)}
        try:
            import repro_torch.api.backends  # noqa: F401
        except BaseException:
            _builtins_loaded = False
            for reg, names in before.items():
                for leftover in set(reg._entries) - names:
                    del reg._entries[leftover]
            raise


def register_algorithm(algo: Algorithm, *, overwrite: bool = False) -> Algorithm:
    ALGORITHMS.register(algo.name, algo, overwrite=overwrite)
    return algo


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    BACKENDS.register(backend.name, backend, overwrite=overwrite)
    return backend


def register_compressor(name: str, make: Callable, *, overwrite: bool = False) -> None:
    """Register a ``(T, k) -> Compressor`` factory under ``name``, visible to
    every algorithm and to ``repro_torch.compressors.get_compressor``."""
    from repro_torch.compressors.core import COMPRESSORS, CUSTOM_COMPRESSORS

    if not overwrite and (name in COMPRESSORS or name in CUSTOM_COMPRESSORS):
        raise ValueError(f"compressor {name!r} already registered")
    CUSTOM_COMPRESSORS[name] = make


def get_algorithm(name: str) -> Algorithm:
    return ALGORITHMS.get(name)


def get_backend(name: str) -> Backend:
    return BACKENDS.get(name)


def list_algorithms() -> list[str]:
    return ALGORITHMS.names()


def list_backends() -> list[str]:
    return BACKENDS.names()
