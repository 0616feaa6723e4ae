"""FedNL-LS -- globalization by backtracking line search (paper Algorithm 2),
port of ``repro.core.fednl_ls``.

The clients' part of the round is FedNL's (:func:`repro_torch.core.fednl.
client_round`; the clients also send f_c(x^k)).  The master takes the
direction d^k = -[H^k]_mu^{-1} grad (Option A) or -(H^k + l^k I)^{-1} grad
(Option B) and backtracks: the smallest integer s >= 0 with

    f(x^k + gamma^s d^k) <= f(x^k) + c gamma^s <grad f(x^k), d^k>

(paper: c = 0.49, gamma = 0.5), at most ``ls_max_steps`` trials, and none at
the FP64 gradient plateau ``||grad|| <= ls_tol``, where the unit step is
taken.

The reference runs the backtracking as a ``lax.while_loop`` whose length
depends on the data.  Here it is a host loop, and each test waits for the
card: one ``.item()`` for the plateau test, then one per Armijo trial (each
trial is one pass of the f oracle over all clients).  A round that takes
the unit step at once makes 2 host syncs, a round at the plateau 1, and a
round that backtracks s times s + 2 (at most ``ls_max_steps`` + 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import prng
from repro_torch.api.accounting import payload_bits_fn, wire_bits_fn
from repro_torch.compressors import get_compressor
from repro_torch.core.fednl import FedNLConfig, FedNLState, client_round
from repro_torch.linalg import newton_solve_optionA, newton_solve_optionB, triu_size, unpack_triu
from repro_torch.objectives.logreg import logreg_f


class LSRoundMetrics(NamedTuple):
    grad_norm: torch.Tensor
    f: torch.Tensor
    l: torch.Tensor
    ls_steps: int  # backtracking steps taken (counted on the host)
    sent_elems: torch.Tensor
    sent_bits: torch.Tensor  # under FedNLConfig.accounting
    sent_bits_payload: torch.Tensor
    sent_bits_wire: torch.Tensor


def make_fednl_ls_round(
    z: torch.Tensor, cfg: FedNLConfig
) -> Callable[[FedNLState], tuple[FedNLState, LSRoundMetrics]]:
    """The Algorithm-2 round transition for problem data ``z``."""
    n_clients, _, d = z.shape
    comp = get_compressor(cfg.compressor, triu_size(d), cfg.k_for(d))
    alpha = comp.alpha if cfg.alpha is None else cfg.alpha
    pay_fn = payload_bits_fn(comp, d)
    wire_fn = wire_bits_fn(comp, d)

    def f_global(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(logreg_f(z, x, cfg.lam))

    def round_fn(state: FedNLState) -> tuple[FedNLState, LSRoundMetrics]:
        key, sub = prng.split(state.key, 2)
        client_keys = prng.split(sub, n_clients) if comp.draws else None
        f_c, grad_c, s_c, l_c, h_local_new, sent_c = client_round(
            z, state.h_local, state.x, client_keys, comp, alpha, cfg.lam
        )
        grad = torch.mean(grad_c, dim=0)
        f0 = torch.mean(f_c)
        l = torch.mean(l_c)
        s = torch.mean(s_c, dim=0)

        h = unpack_triu(state.h_global, d)
        if cfg.option == "A":
            direction = -newton_solve_optionA(h, grad, cfg.mu)
        else:
            direction = -newton_solve_optionB(h, grad, l)
        slope = grad @ direction  # < 0 for a descent direction
        grad_norm = torch.linalg.vector_norm(grad)

        steps, step = 0, 1.0
        if grad_norm.item() > cfg.ls_tol:  # off the plateau: backtrack
            while steps < cfg.ls_max_steps and bool(
                (f_global(state.x + step * direction) > f0 + cfg.ls_c * step * slope).item()
            ):
                steps += 1
                step *= cfg.ls_gamma
        x_new = state.x + step * direction
        h_global_new = state.h_global + alpha * s

        bits_payload = torch.sum(pay_fn(sent_c))
        bits_wire = torch.sum(wire_fn(sent_c))
        metrics = LSRoundMetrics(
            grad_norm=grad_norm,
            f=f0,
            l=l,
            ls_steps=steps,
            sent_elems=torch.sum(sent_c.to(torch.int64)),
            sent_bits=bits_payload if cfg.accounting == "payload" else bits_wire,
            sent_bits_payload=bits_payload,
            sent_bits_wire=bits_wire,
        )
        new_state = FedNLState(
            x=x_new,
            h_local=h_local_new,
            h_global=h_global_new,
            key=key,
            round=state.round + 1,
        )
        return new_state, metrics

    return round_fn
