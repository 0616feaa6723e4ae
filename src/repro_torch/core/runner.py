"""Single-node FedNL driver (port of ``repro.core.runner.run_fednl``).

Initialization and one warm-up round (which builds and loads the kernels at
their first launch) are timed apart from the solve, as the reference times
its compile.  The metrics stay on the device until the run ends; the only
per-round host sync is the grad norm, and only when ``tol`` asks for it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.fednl import FedNLConfig, FedNLState, fednl_init, make_fednl_round
from repro_torch.device import resolve_device
from repro_torch.objectives.logreg import logreg_f, logreg_grad


@dataclasses.dataclass
class RunResult:
    x: np.ndarray
    grad_norms: np.ndarray
    f_vals: np.ndarray
    sent_bits: np.ndarray  # int64
    rounds: int
    wall_time_s: float
    init_time_s: float


@dataclasses.dataclass
class Trajectory:
    """A finished run: final state, per-round metric columns on the host
    (names of :class:`repro_torch.core.fednl.RoundMetrics`), timings."""

    state: FedNLState
    columns: dict[str, np.ndarray]
    rounds: int
    wall_time_s: float
    init_time_s: float


def eval_full(z: torch.Tensor, x: torch.Tensor, lam: float):
    """Exact global f and grad over all clients (diagnostics)."""
    return torch.mean(logreg_f(z, x, lam)), torch.mean(logreg_grad(z, x, lam), dim=0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fednl_trajectory(
    z,
    cfg: FedNLConfig,
    rounds: int,
    tol: float,
    seed: int,
    x0,
    device: torch.device,
) -> Trajectory:
    """init -> warm-up round -> up to ``rounds`` rounds on ``device``,
    stopping after the first round whose grad norm is below ``tol`` (tol > 0)."""
    t0 = time.perf_counter()
    z = torch.as_tensor(z).to(dtype=torch.float64, device=device).contiguous()
    state = fednl_init(z, cfg, x0=x0, seed=seed)
    round_fn = make_fednl_round(z, cfg)
    # warm-up round outside the solve clock (the paper separates
    # "initialization time" from "solve time" the same way)
    round_fn(state)
    _sync(device)
    init_time = time.perf_counter() - t0

    metrics = []
    t1 = time.perf_counter()
    for _ in range(rounds):
        state, m = round_fn(state)
        metrics.append(m)
        if tol > 0.0 and m.grad_norm.item() < tol:
            break
    _sync(device)
    wall = time.perf_counter() - t1
    columns = {
        name: torch.stack([getattr(m, name) for m in metrics]).cpu().numpy()
        for name in (metrics[0]._fields if metrics else ())
    }
    return Trajectory(state, columns, len(metrics), wall, init_time)


def run_fednl(
    z,
    cfg: FedNLConfig,
    rounds: int = 1000,
    tol: float = 0.0,
    seed: int = 0,
    x0=None,
    device: str | torch.device | None = None,
) -> RunResult:
    """Run FedNL on problem data z (n_clients, n_i, d) on ``device`` (default: the card)."""
    traj = fednl_trajectory(z, cfg, rounds, tol, seed, x0, resolve_device(device))
    cols = traj.columns
    return RunResult(
        x=traj.state.x.cpu().numpy(),
        grad_norms=cols.get("grad_norm", np.zeros(0)),
        f_vals=cols.get("f", np.zeros(0)),
        sent_bits=cols.get("sent_bits", np.zeros(0, dtype=np.int64)),
        rounds=traj.rounds,
        wall_time_s=traj.wall_time_s,
        init_time_s=traj.init_time_s,
    )
