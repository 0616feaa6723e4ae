"""``solve(spec)``: the entry point of the port (port of ``repro.api.facade.solve``).

Runs the local backend of the three algorithms, ``fednl``, ``fednl-ls`` and
``fednl-pp``: the same init -> warm-up -> rounds sequence as ``repro``'s
local session, on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from repro_torch.api.report import RoundRecord, RunReport
from repro_torch.api.spec import ALGORITHM_KINDS, ExperimentSpec

_NOT_PORTED_BACKENDS = {
    "sharded": "ROADMAP A13",
    "star-loopback": "ROADMAP A11",
    "star-tcp": "ROADMAP A11",
}


def _full_record(r: int, cols: dict) -> RoundRecord:
    return RoundRecord(
        round=r,
        grad_norm=float(cols["grad_norm"][r]),
        f=float(cols["f"][r]),
        l=float(cols["l"][r]),
        sent_elems=int(cols["sent_elems"][r]),
        sent_bits=int(cols["sent_bits"][r]),
        sent_bits_payload=int(cols["sent_bits_payload"][r]),
        sent_bits_wire=int(cols["sent_bits_wire"][r]),
        ls_steps=int(cols["ls_steps"][r]) if "ls_steps" in cols else None,
    )


def _pp_record(r: int, cols: dict) -> RoundRecord:
    return RoundRecord(
        round=r,
        l=float(cols["l"][r]),
        sent_elems=int(cols["sent_elems"][r]),
        sent_bits=int(cols["sent_bits"][r]),
        sent_bits_payload=int(cols["sent_bits_payload"][r]),
        sent_bits_wire=int(cols["sent_bits_wire"][r]),
        x=cols["x"][r],
        participants=tuple(int(i) for i in cols["idx"][r]),
    )


def solve(spec: ExperimentSpec, z=None, x0=None, device=None) -> RunReport:
    """Run one experiment described by ``spec``.

    ``z`` optionally supplies the problem array ``(n_clients, n_i, d)`` in
    place of ``spec.data``; ``x0`` overrides the zero initial iterate.
    ``device=None`` runs on the card and raises without one.
    """
    import torch

    from repro_torch.core.fednl_pp import server_model
    from repro_torch.core.runner import eval_full, fednl_trajectory, pp_trajectory
    from repro_torch.device import device_name, resolve_device

    kind = ALGORITHM_KINDS.get(spec.algorithm)
    if kind is None:
        raise KeyError(f"unknown algorithm {spec.algorithm!r}; have {sorted(ALGORITHM_KINDS)}")
    if spec.backend != "local":
        where = _NOT_PORTED_BACKENDS.get(spec.backend, "unknown backend")
        raise NotImplementedError(f"backend {spec.backend!r} is not ported ({where})")
    dev = resolve_device(device)
    if z is None:
        z = spec.data.build()
    cfg = spec.fednl_config()
    extras = {"device": device_name(dev)}
    grad_norm_fn = None
    if kind == "full":
        traj = fednl_trajectory(
            z, cfg, spec.rounds, spec.tol, spec.seed, x0, dev,
            line_search=spec.algorithm == "fednl-ls",
        )
        records = [_full_record(r, traj.columns) for r in range(traj.rounds)]
        x = traj.state.x.cpu().numpy()
    else:
        tau = spec.tau_for(z.shape[0])
        traj = pp_trajectory(z, cfg, tau, spec.rounds, spec.seed, x0, dev)
        records = [_pp_record(r, traj.columns) for r in range(traj.rounds)]
        # the deployable model: Algorithm 3, line 4 on the invariants after
        # the last round
        x_final = server_model(traj.state, z.shape[-1])
        x = x_final.cpu().numpy()
        zd, lam = traj.z, cfg.lam

        def grad_norm_fn() -> float:
            return float(torch.linalg.vector_norm(eval_full(zd, x_final, lam)[1]))

        extras["tau"] = tau
    return RunReport(
        spec=spec,
        algorithm=spec.algorithm,
        backend=spec.backend,
        x=x,
        records=records,
        rounds=traj.rounds,
        wall_time_s=traj.wall_time_s,
        init_time_s=traj.init_time_s,
        final_grad_norm_fn=grad_norm_fn,
        extras=extras,
    )
