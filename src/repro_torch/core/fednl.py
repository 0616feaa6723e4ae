"""FedNL -- Federated Newton Learn (paper Algorithm 1), port of ``repro.core.fednl``.

One round (clients c = 1..n as a batch dimension, then the master):

  client c: grad_c = grad f_c(x^k);  D_c = hess f_c(x^k)
            S_c = C(D_c - H_c^k);  l_c = ||H_c^k - D_c||_F
            H_c^{k+1} = H_c^k + alpha S_c
  master:   S = mean_c S_c;  l = mean_c l_c;  grad = mean_c grad_c
            H^{k+1} = H^k + alpha S
            Option A: x^{k+1} = x^k - [H^k]_mu^{-1} grad
            Option B: x^{k+1} = x^k - (H^k + l^k I)^{-1} grad

Hessian-shaped state is packed upper triangle (T = d(d+1)/2).  The clients
are the leading dimension of every client tensor: one SYRK launch and one
selection launch per round serve all of them.  Everything stays on the
device of ``z``; a round makes no host sync.

The PRNG key advances as in the reference's round, for every compressor:
``key, sub = split(state.key)``; the clients' keys ``split(sub, n_clients)``
are made only when the compressor draws (RandSeqK, TopLEK).  Keys and draws
are threefry on the host (:mod:`repro_torch.prng`), bit-exact with
``jax.random``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api.accounting import make_bits_fn as _make_bits_fn
from repro_torch.api.accounting import payload_bits_fn, wire_bits_fn
from repro_torch.compressors import Compressor, get_compressor
from repro_torch.linalg import (
    frob_norm_from_packed,
    newton_solve_optionA,
    newton_solve_optionB,
    triu_size,
    unpack_triu,
)
from repro_torch.objectives.logreg import logreg_oracles_packed


@dataclasses.dataclass(frozen=True)
class FedNLConfig:
    """Hyper-parameters of a FedNL run (defaults = the paper's single-node setup)."""

    compressor: str = "topk"
    k_multiplier: float = 8.0  # the paper's K = 8d entries of the Hessian
    alpha: float | None = None  # None -> the compressor's recommendation (1.0)
    option: str = "B"  # master step rule: "A" (projection) | "B" (l-shift)
    mu: float = 1e-3  # strong-convexity lower bound for Option A
    lam: float = 1e-3  # L2 regularization of the logistic objective
    hess0: str = "exact"  # "exact" | "zero"
    # FedNL-LS (Algorithm 2) backtracking: f(x + g^s d) <= f(x) + c g^s <grad, d>
    ls_c: float = 0.49
    ls_gamma: float = 0.5
    ls_max_steps: int = 30
    # at ||grad|| <= ls_tol the unit step is taken without trials (the Armijo
    # test compares f-values below rounding noise there)
    ls_tol: float = 1e-12
    accounting: str = "payload"  # sent_bits model: "payload" | "wire"

    def __post_init__(self):
        if self.accounting not in ("payload", "wire"):
            raise ValueError(
                f"unknown accounting {self.accounting!r}; use 'payload' | 'wire'"
            )

    def k_for(self, d: int) -> int:
        return max(1, min(triu_size(d), int(self.k_multiplier * d)))


class FedNLState(NamedTuple):
    x: torch.Tensor  # (d,) model
    h_local: torch.Tensor  # (n_clients, T) packed client Hessian shifts H_c^k
    h_global: torch.Tensor  # (T,) packed master estimate H^k = mean_c H_c^k
    key: np.ndarray  # (2,) uint32 threefry key on the host, as repro's state.key
    round: int


class RoundMetrics(NamedTuple):
    grad_norm: torch.Tensor
    f: torch.Tensor
    l: torch.Tensor
    sent_elems: torch.Tensor  # int64: total payload elements uplinked this round
    sent_bits: torch.Tensor  # int64, under FedNLConfig.accounting
    sent_bits_payload: torch.Tensor  # int64, Section-7 payload model
    sent_bits_wire: torch.Tensor  # int64, full framed uplink model


def fednl_init(
    z: torch.Tensor, cfg: FedNLConfig, x0: torch.Tensor | None = None, seed: int = 0
) -> FedNLState:
    """Initial state for problem data z: (n_clients, n_i, d), on z's device."""
    n_clients, _, d = z.shape
    if x0 is None:
        x = torch.zeros(d, dtype=z.dtype, device=z.device)
    else:
        x = torch.as_tensor(x0).to(dtype=z.dtype, device=z.device)
    if cfg.hess0 == "exact":
        _, _, h_local = logreg_oracles_packed(z, x, cfg.lam)
    elif cfg.hess0 == "zero":
        h_local = torch.zeros((n_clients, triu_size(d)), dtype=z.dtype, device=z.device)
    else:
        raise ValueError(f"unknown hess0 {cfg.hess0!r}")
    return FedNLState(
        x=x,
        h_local=h_local,
        h_global=torch.mean(h_local, dim=0),
        key=prng.prng_key(seed),
        round=0,
    )


def make_bits_fn(comp: Compressor, d: int, accounting: str) -> Callable:
    """Deprecated alias of :func:`repro_torch.api.accounting.make_bits_fn`
    (the non-PP form), as ``repro.core.fednl.make_bits_fn``; new code imports
    it from ``repro_torch.api``."""
    return _make_bits_fn(comp, d, accounting, pp=False)


def client_round(
    z: torch.Tensor,
    h_local: torch.Tensor,
    x: torch.Tensor,
    keys: np.ndarray | None,
    comp: Compressor,
    alpha: float,
    lam: float,
):
    """Lines 3-7 of Algorithm 1 for all clients at once; ``keys`` are the
    clients' PRNG keys (n_clients, 2), None for a compressor that draws nothing."""
    d = z.shape[-1]
    f_c, grad_c, hess_c = logreg_oracles_packed(z, x, lam)
    delta = hess_c - h_local
    s_c, sent_c = comp.compress(keys, delta)
    l_c = frob_norm_from_packed(delta, d)
    h_local_new = h_local + alpha * s_c
    return f_c, grad_c, s_c, l_c, h_local_new, sent_c


def master_step(
    x: torch.Tensor,
    h_global_packed: torch.Tensor,
    grad: torch.Tensor,
    l: torch.Tensor,
    cfg: FedNLConfig,
) -> torch.Tensor:
    """Line 11 of Algorithm 1: the Newton-type model update (a leading batch
    of specs, as the sweep's batched round stacks them, is one batch)."""
    h = unpack_triu(h_global_packed, x.shape[-1])
    if cfg.option == "A":
        dx = newton_solve_optionA(h, grad, cfg.mu)
    elif cfg.option == "B":
        dx = newton_solve_optionB(h, grad, l)
    else:
        raise ValueError(f"unknown option {cfg.option!r}")
    return x - dx


def make_fednl_round(
    z: torch.Tensor, cfg: FedNLConfig
) -> Callable[[FedNLState], tuple[FedNLState, RoundMetrics]]:
    """The single-round transition for problem data ``z``."""
    d = z.shape[-1]
    comp = get_compressor(cfg.compressor, triu_size(d), cfg.k_for(d))
    alpha = comp.alpha if cfg.alpha is None else cfg.alpha
    pay_fn = payload_bits_fn(comp, d)
    wire_fn = wire_bits_fn(comp, d)
    n_clients = z.shape[0]

    def round_fn(state: FedNLState) -> tuple[FedNLState, RoundMetrics]:
        key, sub = prng.split(state.key, 2)
        client_keys = prng.split(sub, n_clients) if comp.draws else None
        f_c, grad_c, s_c, l_c, h_local_new, sent_c = client_round(
            z, state.h_local, state.x, client_keys, comp, alpha, cfg.lam
        )
        grad = torch.mean(grad_c, dim=0)
        s = torch.mean(s_c, dim=0)
        l = torch.mean(l_c)
        f = torch.mean(f_c)

        x_new = master_step(state.x, state.h_global, grad, l, cfg)
        h_global_new = state.h_global + alpha * s

        bits_payload = torch.sum(pay_fn(sent_c))
        bits_wire = torch.sum(wire_fn(sent_c))
        metrics = RoundMetrics(
            grad_norm=torch.linalg.vector_norm(grad),
            f=f,
            l=l,
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


def state_to_numpy(state: NamedTuple, prefix: str = "state.") -> dict[str, np.ndarray]:
    """A FedNL or FedNL-PP state as the checkpoint arrays
    ``repro.api.backends.state_arrays`` makes of the reference's state."""
    out = {prefix + f: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
           for f, v in zip(state._fields, state)}
    out[prefix + "round"] = np.asarray(state.round, dtype=np.int64)
    return out


def state_from_numpy(
    arrays: dict[str, np.ndarray],
    device: str | torch.device,
    prefix: str = "state.",
    state_type: type = FedNLState,
) -> NamedTuple:
    """Rebuild a state of ``state_type`` (``FedNLState``, or
    ``repro_torch.core.fednl_pp.FedNLPPState``) from
    ``repro.api.backends.state_arrays`` output of the reference's state of
    the same name, on ``device``.  The key array is kept as it is."""
    missing = [f for f in state_type._fields if prefix + f not in arrays]
    if missing:
        raise ValueError(f"state arrays are missing {missing}")
    fields = {
        f: torch.tensor(arrays[prefix + f], dtype=torch.float64, device=device)
        for f in state_type._fields if f not in ("key", "round")
    }
    return state_type(
        **fields,
        key=np.asarray(arrays[prefix + "key"]),
        round=int(arrays[prefix + "round"]),
    )
