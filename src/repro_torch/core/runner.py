"""Single-node drivers and centralized baselines (port of ``repro.core.runner``).

``run_fednl`` runs FedNL (Algorithm 1) or, with ``line_search=True``,
FedNL-LS (Algorithm 2); ``run_fednl_pp`` runs FedNL-PP (Algorithm 3).
Initialization and one warm-up round (which builds and loads the kernels at
their first launch) are timed apart from the solve, as the reference times
its compile.  The metrics stay on the device until the run ends; the only
per-round host sync of FedNL and FedNL-PP is the grad norm, and only when
``tol`` asks for it (FedNL-LS adds its line search's, ``core/fednl_ls.py``).

``newton_baseline`` (centralized Newton on the pooled data) and
``gd_baseline`` (gradient descent) are the reference's first- and
second-order solver archetypes; they sync every iteration, as the
reference's loops do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.fednl import FedNLConfig, fednl_init, make_fednl_round
from repro_torch.core.fednl_ls import make_fednl_ls_round
from repro_torch.core.fednl_pp import fednl_pp_init, make_fednl_pp_round, server_model
from repro_torch.device import resolve_device
from repro_torch.objectives.logreg import logreg_f, logreg_grad, logreg_hess


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
class PPRunResult:
    """A FedNL-PP run.  The server never sees the global gradient, so
    ``grad_norm`` is one diagnostic after the run, at ``x``."""

    x: np.ndarray  # the model solved from the invariants after the last round
    x_hist: np.ndarray  # (rounds, d): the model each round produced
    l_vals: np.ndarray
    sent_bits: np.ndarray  # int64
    rounds: int
    grad_norm: float
    wall_time_s: float
    init_time_s: float


@dataclasses.dataclass
class Trajectory:
    """A finished run: final state, per-round metric columns on the host
    (names of the round's metrics tuple), timings."""

    state: Any
    z: torch.Tensor  # the problem data on the run's device
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


def _column(values: list) -> np.ndarray:
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values).cpu().numpy()
    return np.stack([np.asarray(v) for v in values])


def _trajectory(
    z, device: torch.device, init: Callable, make_round: Callable, rounds: int, tol: float
) -> Trajectory:
    """init -> warm-up round -> up to ``rounds`` rounds on ``device``,
    stopping after the first round whose grad norm is below ``tol`` (tol > 0)."""
    t0 = time.perf_counter()
    z = torch.as_tensor(z).to(dtype=torch.float64, device=device).contiguous()
    state = init(z)
    round_fn = make_round(z)
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
        name: _column([getattr(m, name) for m in metrics])
        for name in (metrics[0]._fields if metrics else ())
    }
    return Trajectory(state, z, columns, len(metrics), wall, init_time)


def fednl_trajectory(
    z,
    cfg: FedNLConfig,
    rounds: int,
    tol: float,
    seed: int,
    x0,
    device: torch.device,
    line_search: bool = False,
) -> Trajectory:
    """A FedNL (``line_search``: FedNL-LS) run on ``device``."""
    make = make_fednl_ls_round if line_search else make_fednl_round
    return _trajectory(
        z, device, lambda zd: fednl_init(zd, cfg, x0=x0, seed=seed),
        lambda zd: make(zd, cfg), rounds, tol,
    )


def pp_trajectory(
    z, cfg: FedNLConfig, tau: int, rounds: int, seed: int, x0, device: torch.device
) -> Trajectory:
    """A FedNL-PP run of ``rounds`` rounds on ``device``."""
    return _trajectory(
        z, device, lambda zd: fednl_pp_init(zd, cfg, x0=x0, seed=seed),
        lambda zd: make_fednl_pp_round(zd, cfg, tau), rounds, 0.0,
    )


def run_fednl(
    z,
    cfg: FedNLConfig,
    rounds: int = 1000,
    tol: float = 0.0,
    line_search: bool = False,
    seed: int = 0,
    x0=None,
    device: str | torch.device | None = None,
) -> RunResult:
    """Run FedNL (``line_search``: FedNL-LS) on problem data z
    (n_clients, n_i, d) on ``device`` (default: the card)."""
    traj = fednl_trajectory(
        z, cfg, rounds, tol, seed, x0, resolve_device(device), line_search=line_search
    )
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


def run_fednl_pp(
    z,
    cfg: FedNLConfig,
    tau: int,
    rounds: int = 1000,
    seed: int = 0,
    x0=None,
    device: str | torch.device | None = None,
) -> PPRunResult:
    """Run FedNL-PP on problem data z (n_clients, n_i, d) on ``device``
    (default: the card).  The final model is solved from the server's
    invariants after the last round (``x_hist[-1]`` is one update behind),
    and its grad norm is one pass of :func:`eval_full`."""
    traj = pp_trajectory(z, cfg, tau, rounds, seed, x0, resolve_device(device))
    d = traj.z.shape[-1]
    x_final = server_model(traj.state, d)
    _, g = eval_full(traj.z, x_final, cfg.lam)
    cols = traj.columns
    return PPRunResult(
        x=x_final.cpu().numpy(),
        x_hist=cols.get("x", np.zeros((0, d))),
        l_vals=cols.get("l", np.zeros(0)),
        sent_bits=cols.get("sent_bits", np.zeros(0, dtype=np.int64)),
        rounds=traj.rounds,
        grad_norm=float(torch.linalg.vector_norm(g)),
        wall_time_s=traj.wall_time_s,
        init_time_s=traj.init_time_s,
    )


# ---------------------------------------------------------------------------
# centralized baselines
# ---------------------------------------------------------------------------


def _pooled(z, device) -> torch.Tensor:
    z = torch.as_tensor(z).to(dtype=torch.float64, device=device)
    return z.reshape(-1, z.shape[-1])


def _baseline(step: Callable, x: torch.Tensor, iters: int, tol: float, newton: bool) -> RunResult:
    """One warm-up step, then up to ``iters`` steps with the grad norm read
    on the host each step (the reference's loop).  Newton stops before the
    step whose grad norm is below ``tol``; gradient descent after it."""
    device = x.device
    t0 = time.perf_counter()
    step(x)
    _sync(device)
    init = time.perf_counter() - t0
    gns, fs = [], []
    t1 = time.perf_counter()
    for _ in range(iters):
        f, g, x_next = step(x)
        gn = float(torch.linalg.vector_norm(g))
        gns.append(gn)
        fs.append(float(f))
        if newton and gn < tol:
            break
        x = x_next
        if not newton and gn < tol:
            break
    wall = time.perf_counter() - t1
    return RunResult(
        x=x.cpu().numpy(),
        grad_norms=np.asarray(gns),
        f_vals=np.asarray(fs),
        sent_bits=np.zeros(len(gns), dtype=np.int64),
        rounds=len(gns),
        wall_time_s=wall,
        init_time_s=init,
    )


def newton_baseline(
    z, lam: float, iters: int = 50, tol: float = 1e-14,
    device: str | torch.device | None = None,
) -> RunResult:
    """Centralized Newton on the pooled data (all clients' rows on one node)."""
    zf = _pooled(z, resolve_device(device))

    def step(x):
        g = logreg_grad(zf, x, lam)
        return logreg_f(zf, x, lam), g, x - torch.linalg.solve(logreg_hess(zf, x, lam), g)

    x0 = torch.zeros(zf.shape[1], dtype=zf.dtype, device=zf.device)
    return _baseline(step, x0, iters, tol, newton=True)


def gd_baseline(
    z, lam: float, iters: int = 5000, tol: float = 1e-9, lr: float | None = None,
    device: str | torch.device | None = None,
) -> RunResult:
    """Centralized gradient descent with step 1/L, L = ||Z||_2^2 / (4 n) + lam
    (the logistic loss's smoothness), or ``lr``."""
    zf = _pooled(z, resolve_device(device))
    n = zf.shape[0]
    l_smooth = float(torch.linalg.matrix_norm(zf, ord=2) ** 2 / (4 * n) + lam)
    step_size = 1.0 / l_smooth if lr is None else lr

    def step(x):
        g = logreg_grad(zf, x, lam)
        return logreg_f(zf, x, lam), g, x - step_size * g

    x0 = torch.zeros(zf.shape[1], dtype=zf.dtype, device=zf.device)
    return _baseline(step, x0, iters, tol, newton=False)
