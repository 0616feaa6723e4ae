"""solve(spec) / solve_many(sweep): the entry points of the port (port of
``repro.api.facade``).

``solve`` validates one spec against the registries, builds (or takes) the
federated problem and runs it through a session of its backend; ``solve_many``
does the same for a whole :class:`SweepSpec`, running compatible specs as
batched groups (``repro_torch.api.batch``).  Both run on the card unless
``device="cpu"`` is asked for, and raise without a card.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.api.registry import Algorithm, Backend, get_algorithm, get_backend
from repro_torch.api.report import RunReport, SweepReport
from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.sweep import SweepSpec


def check_spec(
    spec: ExperimentSpec, algo: Algorithm, backend: Backend, *, z=None, x0=None
) -> None:
    """The checks ``solve``, ``open_session`` and ``solve_many`` share, so a
    spec that fails one fails all of them, before anything runs: the
    reference's capability checks, then the Hessian path the port lacks."""
    if not backend.supports(algo):
        raise ValueError(
            f"backend {backend.name!r} does not support algorithm {algo.name!r} "
            "(it only speaks the protocols it implements)"
        )
    if x0 is not None and not backend.supports_x0:
        raise ValueError(f"backend {backend.name!r} does not support an x0 override")
    if spec.fault is not None and not backend.supports_faults:
        raise ValueError(
            f"backend {backend.name!r} cannot inject faults; a FaultSpec "
            "needs a wire backend (star-loopback / star-tcp) — running it "
            "fault-free here would silently change the experiment"
        )
    if z is not None and not backend.needs_problem:
        raise ValueError(
            f"backend {backend.name!r} rebuilds the problem from spec.data in its "
            "worker processes; a pre-built z cannot be shipped to it"
        )
    topo_live = spec.topology is not None and not spec.topology.trivial
    mem_live = spec.membership is not None and not spec.membership.trivial
    if (topo_live or mem_live) and not backend.supports_topology:
        what = "topology" if topo_live else "membership"
        raise ValueError(
            f"backend {backend.name!r} cannot run a non-trivial {what} spec; "
            "trees, async aggregation and membership events need a wire "
            "backend (star-loopback / star-tcp) — running the flat sync "
            "star here would silently change the experiment"
        )
    if spec.hessian_impl == "jnp":
        raise ValueError(
            "hessian='jnp' is the reference's XLA-only parity path; the port has "
            "one Hessian kernel, the SYRK kernel, which 'fused' and 'pallas' both "
            "run -- use one of those"
        )


def solve(spec: ExperimentSpec, z=None, x0=None, device=None) -> RunReport:
    """Run one experiment described by ``spec``: ``open_session(spec).run()``.

    ``z`` optionally supplies the problem array ``(n_clients, n_i, d)`` in
    place of ``spec.data``; ``x0`` overrides the zero initial iterate.
    ``device=None`` runs on the card and raises without one.
    """
    algo = get_algorithm(spec.algorithm)
    backend = get_backend(spec.backend)
    if backend.supports_sessions:
        from repro_torch.api.session import open_session

        with open_session(spec, z=z, x0=x0, device=device) as session:
            return session.run()
    # run-to-completion backends (custom registrations without open())
    check_spec(spec, algo, backend, z=z, x0=x0)
    if z is None and backend.needs_problem:
        z = spec.data.build()
    return backend.run(spec, algo, z, x0, device=device)


def solve_many(
    sweep: SweepSpec | Iterable[ExperimentSpec], device=None
) -> SweepReport:
    """Run a whole sweep (a :class:`SweepSpec` or any iterable of specs) and
    return a :class:`SweepReport`, one :class:`RunReport` per spec in
    expansion order.

    Shape-compatible full-participation specs on the local backend run as
    batched groups: each round of a group is one round over all its specs,
    each kernel launched once for the whole group; everything else runs per
    spec through ``solve()``.  Each decision is in ``SweepReport.log``.
    ``device`` as in :func:`solve`.
    """
    from repro_torch.api.batch import run_sweep
    from repro_torch.device import resolve_device

    if isinstance(sweep, SweepSpec):
        specs, batch_mode, sweep_obj = sweep.specs(), sweep.batch, sweep
    else:
        specs, batch_mode, sweep_obj = tuple(sweep), "auto", None
        for s in specs:
            if not isinstance(s, ExperimentSpec):
                raise TypeError(
                    f"solve_many takes a SweepSpec or ExperimentSpecs, got {type(s).__name__}"
                )
    if not specs:
        raise ValueError("empty sweep: nothing to solve")
    return run_sweep(specs, batch_mode, sweep_obj, resolve_device(device))
