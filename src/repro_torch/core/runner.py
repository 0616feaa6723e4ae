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
from typing import Callable

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


class RoundLoop:
    """A run on ``device``: ``start(z)`` builds the state and the round
    (``z`` uploaded as f64), then one warm-up round outside the clock (it
    builds and loads the kernels at their first launch; rounds are pure, so
    the state is unchanged), then rounds in chunks whose metrics stay on the
    device until the chunk ends.  ``run_fednl``, ``run_fednl_pp``, the local
    session handle (``api/backends.py``) and the sweep's batched groups
    (``api/batch.py``) all step this one loop."""

    def __init__(self, z, device: torch.device, start: Callable):
        t0 = time.perf_counter()
        self.device = device
        self.z = torch.as_tensor(z).to(dtype=torch.float64, device=device).contiguous()
        self.state, self.round_fn = start(self.z)
        # warm-up round outside the solve clock (the paper separates
        # "initialization time" from "solve time" the same way)
        self.round_fn(self.state)
        _sync(device)
        self.init_time_s = time.perf_counter() - t0
        self.wall_time_s = 0.0

    def step(self, n: int, tol: float = 0.0) -> list:
        """Up to ``n`` rounds and one host sync at their end; with tol > 0
        each round's grad norm is read, and the chunk stops after the first
        round below ``tol``.  Returns the rounds' metrics tuples."""
        metrics = []
        t1 = time.perf_counter()
        for _ in range(n):
            self.state, m = self.round_fn(self.state)
            metrics.append(m)
            if tol > 0.0 and m.grad_norm.item() < tol:
                break
        _sync(self.device)
        self.wall_time_s += time.perf_counter() - t1
        return metrics


def metric_columns(metrics: list) -> dict[str, np.ndarray]:
    """Per-round metrics tuples -> host columns by name, one copy each."""
    if not metrics:
        return {}
    return {name: _column([getattr(m, name) for m in metrics]) for name in metrics[0]._fields}


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
    make = make_fednl_ls_round if line_search else make_fednl_round
    loop = RoundLoop(
        z, resolve_device(device),
        lambda zd: (fednl_init(zd, cfg, x0=x0, seed=seed), make(zd, cfg)),
    )
    metrics = loop.step(rounds, tol)
    cols = metric_columns(metrics)
    return RunResult(
        x=loop.state.x.cpu().numpy(),
        grad_norms=cols.get("grad_norm", np.zeros(0)),
        f_vals=cols.get("f", np.zeros(0)),
        sent_bits=cols.get("sent_bits", np.zeros(0, dtype=np.int64)),
        rounds=len(metrics),
        wall_time_s=loop.wall_time_s,
        init_time_s=loop.init_time_s,
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
    loop = RoundLoop(
        z, resolve_device(device),
        lambda zd: (fednl_pp_init(zd, cfg, x0=x0, seed=seed), make_fednl_pp_round(zd, cfg, tau)),
    )
    metrics = loop.step(rounds)
    cols = metric_columns(metrics)
    d = loop.z.shape[-1]
    x_final = server_model(loop.state, d)
    _, g = eval_full(loop.z, x_final, cfg.lam)
    return PPRunResult(
        x=x_final.cpu().numpy(),
        x_hist=cols.get("x", np.zeros((0, d))),
        l_vals=cols.get("l", np.zeros(0)),
        sent_bits=cols.get("sent_bits", np.zeros(0, dtype=np.int64)),
        rounds=len(metrics),
        grad_norm=float(torch.linalg.vector_norm(g)),
        wall_time_s=loop.wall_time_s,
        init_time_s=loop.init_time_s,
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
