"""FedNL-PP -- partial participation (paper Algorithm 3), port of
``repro.core.fednl_pp``.

The server's model is implicit: it stores H^k (packed), l^k and g^k and
recovers x^{k+1} = (H^k + l^k I)^{-1} g^k.  Each round a subset S^k of tau
clients, drawn uniformly without replacement, participates:

    w_i       = x^{k+1}
    H_i^{k+1} = H_i^k + alpha C(D_i - H_i^k),       D_i = hess f_i(w_i)
    l_i^{k+1} = ||H_i^{k+1} - D_i||_F
    g_i^{k+1} = (H_i^{k+1} + l_i^{k+1} I) w_i - grad f_i(w_i)

and uplinks (C(D_i - H_i^k), l_i^{k+1} - l_i^k, g_i^{k+1} - g_i^k); the server
keeps g^k = mean_i g_i^k and l^k = mean_i l_i^k.

Only the tau chosen clients compute: their data is gathered into one
(tau, n_i, d) batch, which goes through the SYRK kernel and the compressor's
selection kernel as one launch each, and the state is updated at their rows
out of place (``index_copy``), so a state stays valid after a round is run
from it, as the reference's pure round leaves it.  The key split, the choice
of clients (``choice(k_sel, n, (tau,), replace=False)``, threefry on the
host, bit-exact with ``jax.random``) and the clients' keys are made on the
host; the chosen indices are uploaded.  The server's solve is
:func:`repro_torch.linalg.cholesky_solve`, which makes no host sync, so a
round makes none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api.accounting import make_bits_fn, payload_bits_fn, wire_bits_fn
from repro_torch.compressors import get_compressor
from repro_torch.compressors.core import upload_draws
from repro_torch.core.fednl import FedNLConfig
from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, triu_size, unpack_triu
from repro_torch.objectives.logreg import logreg_oracles_packed


class FedNLPPState(NamedTuple):
    h_local: torch.Tensor  # (n_clients, T)
    l_local: torch.Tensor  # (n_clients,)
    g_local: torch.Tensor  # (n_clients, d)
    w_local: torch.Tensor  # (n_clients, d)
    h_global: torch.Tensor  # (T,)
    l_global: torch.Tensor  # ()
    g_global: torch.Tensor  # (d,)
    key: np.ndarray  # (2,) uint32 threefry key on the host
    round: int


class PPRoundMetrics(NamedTuple):
    x: torch.Tensor  # the model the server produced this round
    l: torch.Tensor  # the server's l^k that produced it
    idx: np.ndarray  # (tau,) int64: the clients chosen this round
    sent_elems: torch.Tensor
    sent_bits: torch.Tensor  # under FedNLConfig.accounting
    sent_bits_payload: torch.Tensor
    sent_bits_wire: torch.Tensor


def _shifted_apply(h_packed: torch.Tensor, l: torch.Tensor, x: torch.Tensor, d: int) -> torch.Tensor:
    """(H_i + l_i I) x per client: h_packed (m, T), l (m,) -> (m, d)."""
    eye = torch.eye(d, dtype=h_packed.dtype, device=h_packed.device)
    return (unpack_triu(h_packed, d) + l[:, None, None] * eye) @ x


def server_model(state: FedNLPPState, d: int) -> torch.Tensor:
    """Algorithm 3, line 4: x = (H + l I)^{-1} g from the server's invariants."""
    eye = torch.eye(d, dtype=state.h_global.dtype, device=state.h_global.device)
    return cholesky_solve(unpack_triu(state.h_global, d) + state.l_global * eye, state.g_global)


def fednl_pp_init(
    z: torch.Tensor, cfg: FedNLConfig, x0: torch.Tensor | None = None, seed: int = 0
) -> FedNLPPState:
    """Initial state for problem data z: (n_clients, n_i, d), on z's device;
    every client's oracles at x0 in one batch."""
    n_clients, _, d = z.shape
    if x0 is None:
        x = torch.zeros(d, dtype=z.dtype, device=z.device)
    else:
        x = torch.as_tensor(x0).to(dtype=z.dtype, device=z.device)
    _, grad, hess = logreg_oracles_packed(z, x, cfg.lam)
    if cfg.hess0 == "exact":
        h_local = hess
    elif cfg.hess0 == "zero":
        h_local = torch.zeros_like(hess)
    else:
        raise ValueError(f"unknown hess0 {cfg.hess0!r}")
    l_local = frob_norm_from_packed(h_local - hess, d)
    g_local = _shifted_apply(h_local, l_local, x, d) - grad
    return FedNLPPState(
        h_local=h_local,
        l_local=l_local,
        g_local=g_local,
        w_local=x.expand(n_clients, d).clone(),
        h_global=torch.mean(h_local, dim=0),
        l_global=torch.mean(l_local),
        g_global=torch.mean(g_local, dim=0),
        key=prng.prng_key(seed),
        round=0,
    )


def make_pp_bits_fn(comp, d: int, accounting: str) -> Callable:
    """Deprecated alias of :func:`repro_torch.api.accounting.make_bits_fn`
    with ``pp=True``, as ``repro.core.fednl_pp.make_pp_bits_fn``; new code
    imports it from ``repro_torch.api``."""
    return make_bits_fn(comp, d, accounting, pp=True)


def make_fednl_pp_round(
    z: torch.Tensor, cfg: FedNLConfig, tau: int
) -> Callable[[FedNLPPState], tuple[FedNLPPState, PPRoundMetrics]]:
    """The Algorithm-3 round transition for problem data ``z`` and tau
    participants per round."""
    n_clients, _, d = z.shape
    if not 0 < tau <= n_clients:
        raise ValueError(f"need 0 < tau <= n, got tau={tau}, n={n_clients}")
    comp = get_compressor(cfg.compressor, triu_size(d), cfg.k_for(d))
    alpha = comp.alpha if cfg.alpha is None else cfg.alpha
    pay_fn = payload_bits_fn(comp, d, pp=True)
    wire_fn = wire_bits_fn(comp, d, pp=True)

    def round_fn(state: FedNLPPState) -> tuple[FedNLPPState, PPRoundMetrics]:
        # the server's model (line 4), then tau clients u.a.r. (line 5)
        x = server_model(state, d)
        key, k_sel, k_comp = prng.split(state.key, 3)
        idx = prng.choice(k_sel, n_clients, (tau,), replace=False)
        client_keys = prng.split(k_comp, tau) if comp.draws else None
        rows = upload_draws(idx, z.device)

        # lines 9-13 for the chosen clients, as one batch
        h_old = state.h_local.index_select(0, rows)
        _, grad_i, d_i = logreg_oracles_packed(z.index_select(0, rows), x, cfg.lam)
        s_i, sent_i = comp.compress(client_keys, d_i - h_old)
        h_new = h_old + alpha * s_i
        l_new = frob_norm_from_packed(h_new - d_i, d)
        g_new = _shifted_apply(h_new, l_new, x, d) - grad_i

        # the uplinked deltas and the server's invariants (lines 18-20)
        dl = l_new - state.l_local.index_select(0, rows)
        dg = g_new - state.g_local.index_select(0, rows)
        new_state = FedNLPPState(
            h_local=state.h_local.index_copy(0, rows, h_new),
            l_local=state.l_local.index_copy(0, rows, l_new),
            g_local=state.g_local.index_copy(0, rows, g_new),
            w_local=state.w_local.index_copy(0, rows, x.expand(tau, d)),
            h_global=state.h_global + (alpha / n_clients) * torch.sum(s_i, dim=0),
            l_global=state.l_global + torch.sum(dl) / n_clients,
            g_global=state.g_global + torch.sum(dg, dim=0) / n_clients,
            key=key,
            round=state.round + 1,
        )
        # each message is the triple S_i || dl_i || dg_i
        bits_payload = torch.sum(pay_fn(sent_i))
        bits_wire = torch.sum(wire_fn(sent_i))
        metrics = PPRoundMetrics(
            x=x,
            l=state.l_global,
            idx=idx,
            sent_elems=torch.sum(sent_i.to(torch.int64)),
            sent_bits=bits_payload if cfg.accounting == "payload" else bits_wire,
            sent_bits_payload=bits_payload,
            sent_bits_wire=bits_wire,
        )
        return new_state, metrics

    return round_fn
