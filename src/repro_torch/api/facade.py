"""``solve(spec)``: the entry point of the port (port of ``repro.api.facade.solve``).

Runs the local backend of the ``fednl`` algorithm: the same
init -> warm-up -> rounds sequence as ``repro``'s local session, on the card
unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from repro_torch.api.report import RoundRecord, RunReport
from repro_torch.api.spec import ExperimentSpec

_NOT_PORTED_ALGORITHMS = {
    "fednl-ls": "ROADMAP A9",
    "fednl-pp": "ROADMAP A9",
}
_NOT_PORTED_BACKENDS = {
    "sharded": "ROADMAP A13",
    "star-loopback": "ROADMAP A11",
    "star-tcp": "ROADMAP A11",
}


def solve(spec: ExperimentSpec, z=None, x0=None, device=None) -> RunReport:
    """Run one experiment described by ``spec``.

    ``z`` optionally supplies the problem array ``(n_clients, n_i, d)`` in
    place of ``spec.data``; ``x0`` overrides the zero initial iterate.
    ``device=None`` runs on the card and raises without one.
    """
    from repro_torch.core.runner import fednl_trajectory
    from repro_torch.device import device_name, resolve_device

    if spec.algorithm != "fednl":
        where = _NOT_PORTED_ALGORITHMS.get(spec.algorithm, "unknown algorithm")
        raise NotImplementedError(f"algorithm {spec.algorithm!r} is not ported ({where})")
    if spec.backend != "local":
        where = _NOT_PORTED_BACKENDS.get(spec.backend, "unknown backend")
        raise NotImplementedError(f"backend {spec.backend!r} is not ported ({where})")
    dev = resolve_device(device)
    if z is None:
        z = spec.data.build()
    traj = fednl_trajectory(
        z, spec.fednl_config(), spec.rounds, spec.tol, spec.seed, x0, dev
    )
    cols = traj.columns
    records = [
        RoundRecord(
            round=r,
            grad_norm=float(cols["grad_norm"][r]),
            f=float(cols["f"][r]),
            l=float(cols["l"][r]),
            sent_elems=int(cols["sent_elems"][r]),
            sent_bits=int(cols["sent_bits"][r]),
            sent_bits_payload=int(cols["sent_bits_payload"][r]),
            sent_bits_wire=int(cols["sent_bits_wire"][r]),
        )
        for r in range(traj.rounds)
    ]
    return RunReport(
        spec=spec,
        algorithm=spec.algorithm,
        backend=spec.backend,
        x=traj.state.x.cpu().numpy(),
        records=records,
        rounds=traj.rounds,
        wall_time_s=traj.wall_time_s,
        init_time_s=traj.init_time_s,
        extras={"device": device_name(dev)},
    )
