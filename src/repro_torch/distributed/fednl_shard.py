"""Multi-node FedNL over ``torch.distributed``: clients sharded across ranks
(port of ``repro.distributed.fednl_shard``).

The paper's multi-node setting (Section 7, 9.3) is a star: n clients uplink
(grad_i, S_i, l_i) to one master.  Over a process group the mapping is the
reference's over a mesh:

  * clients -> ranks: each rank holds a contiguous block of n / world
    clients and runs the batched client body on it (one SYRK launch and one
    selection launch per rank per round);
  * the master's reduction -> collectives;
  * the Newton solve -> replicated on every rank (d is small; cheaper than a
    broadcast of x afterwards).

Two aggregations, the collective being the communication cost:

  dense_psum        every client's correction densified locally, the rank's
                    sum all-reduced as one length-T vector (with the grad,
                    l and f in the same buffer): ~T * 8 bytes per rank.
  sparse_allgather  the sparsifiers' (int32 idx, value) pairs all-gathered,
                    k per client (``Compressor.compress_sparse``), and added
                    up on every rank: ~n_clients * k * 12 bytes.

Each message is decompressed into its own row and the rows are summed in
client order: an ``index_add_`` of colliding indices on the card adds in the
order its atomics land, which changes the last bit from run to run, and a
session must be the same run bit for bit (no two pairs of one message share
an index, but for TopLEK's padding pairs, whose value is 0.0).

The PRNG follows the reference's per-device streams bit for bit: the
round's subkey is folded with the rank (``prng.fold_in``), then split into
the rank's client keys.  ``sent_bits`` are the compressor's payload and wire
bits, summed over the world, as the reference reports them
(``repro_torch.api.accounting.sharded_uplink_bits`` is a separate model of
what the collective moves).

The functions take a process group (``None``: the default group) where the
reference takes a mesh; :mod:`repro_torch.distributed.world` sets the group
up.  ``z`` is the rank's block of clients (:func:`shard_problem`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.api.accounting import SHARDED_AGGREGATES, payload_bits_fn, wire_bits_fn
from repro_torch.compressors import get_compressor
from repro_torch.core.fednl import (
    FedNLConfig,
    FedNLState,
    RoundMetrics,
    client_round,
    fednl_init,
    master_step,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core.runner import RoundLoop, metric_columns
from repro_torch.linalg import frob_norm_from_packed, triu_size
from repro_torch.objectives.logreg import logreg_oracles_packed

AXIS = "data"  # the clients' axis, as the reference's mesh names it (in its errors)


def rank_and_world(group=None) -> tuple[int, int]:
    """This process's rank and the world's size in ``group``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded round needs an initialised process group: "
            "repro_torch.distributed.world_of_one(device), or spawned ranks "
            "(repro_torch.distributed.ShardedWorld)"
        )
    return dist.get_rank(group), dist.get_world_size(group)


def check_shardable(n_clients: int, n_dev: int, comp, aggregate: str) -> None:
    """The reference's refusals, before anything runs."""
    if aggregate not in SHARDED_AGGREGATES:
        raise ValueError(
            f"unknown aggregate {aggregate!r}; use {' | '.join(SHARDED_AGGREGATES)}"
        )
    if n_clients % n_dev:
        raise ValueError(f"n_clients={n_clients} not divisible by mesh axis {AXIS}={n_dev}")
    if aggregate == "sparse_allgather" and comp.compress_sparse is None:
        raise ValueError(f"{comp.name} has no sparse form; use dense_psum")


def shard_problem(z, group=None, device=None) -> torch.Tensor:
    """This rank's contiguous block of the clients of ``z`` (n_clients, n_i,
    d), as f64 on ``device`` (None: the card)."""
    from repro_torch.device import resolve_device

    rank, world = rank_and_world(group)
    n_clients = z.shape[0]
    if n_clients % world:
        raise ValueError(f"n_clients={n_clients} not divisible by mesh axis {AXIS}={world}")
    n_loc = n_clients // world
    block = z[rank * n_loc:(rank + 1) * n_loc]
    return torch.as_tensor(block).to(dtype=torch.float64, device=resolve_device(device)).contiguous()


def sharded_fednl_init(z: torch.Tensor, cfg: FedNLConfig, group=None, seed: int = 0) -> FedNLState:
    """The initial state with ``h_local`` this rank's block (n_loc, T) and
    ``x``, ``h_global``, ``key`` replicated: H^0 is the mean over all the
    clients, the ranks' sums all-reduced."""
    _, world = rank_and_world(group)
    state = fednl_init(z, cfg, seed=seed)
    h_sum = torch.sum(state.h_local, dim=0)
    dist.all_reduce(h_sum, group=group)
    return state._replace(h_global=h_sum / (z.shape[0] * world))


def _rows(idx: torch.Tensor, vals: torch.Tensor, t: int) -> torch.Tensor:
    """Messages (m, k) of (index, value) pairs -> their dense rows (m, T):
    one ``index_add_`` over the flattened m * T entries."""
    m = idx.shape[0]
    flat = (torch.arange(m, device=idx.device)[:, None] * t + idx.long()).reshape(-1)
    out = torch.zeros(m * t, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1)).view(m, t)


def make_sharded_fednl_step(
    n_clients: int, d: int, cfg: FedNLConfig, group=None,
    aggregate: str = "dense_psum", payload_dtype: torch.dtype | None = None,
):
    """Shape-only builder: returns ``step(z, h_local, x, h_global, key)`` for
    this rank's block ``z`` (n_clients / world, n_i, d) and its ``h_local``.

    ``payload_dtype``: a cast of the gathered VALUES of ``sparse_allgather``
    (``torch.float32`` halves them); the clients' own H_i take the values
    as computed, as in the reference."""
    t = triu_size(d)
    comp = get_compressor(cfg.compressor, t, cfg.k_for(d))
    alpha = comp.alpha if cfg.alpha is None else cfg.alpha
    pay_fn = payload_bits_fn(comp, d)
    wire_fn = wire_bits_fn(comp, d)
    rank, world = rank_and_world(group)
    check_shardable(n_clients, world, comp, aggregate)
    n_loc = n_clients // world

    def step(z, h_loc, x, h_global, key):
        # the rank's PRNG stream: fold in its position on the axis
        client_keys = prng.split(prng.fold_in(key, rank), n_loc) if comp.draws else None
        if aggregate == "dense_psum":
            f_c, grad_c, s_c, l_c, h_loc_new, sent_c = client_round(
                z, h_loc, x, client_keys, comp, alpha, cfg.lam)
            # s, grad, l and f in one all-reduce (a sum per element, as four would be)
            buf = torch.cat([torch.sum(s_c, dim=0), torch.sum(grad_c, dim=0),
                             torch.sum(l_c)[None], torch.sum(f_c)[None]])
            dist.all_reduce(buf, group=group)
            s = buf[:t] / n_clients
            rest = buf[t:]
        else:  # sparse_allgather
            f_c, grad_c, hess_c = logreg_oracles_packed(z, x, cfg.lam)
            delta = hess_c - h_loc
            idx, vals, sent_c = comp.compress_sparse(client_keys, delta)
            l_c = frob_norm_from_packed(delta, d)
            h_loc_new = h_loc + alpha * _rows(idx, vals, t)
            # the compressed collective: only (idx, val) pairs cross
            if payload_dtype is not None:
                vals = vals.to(payload_dtype)
            idx_all = idx.new_empty((n_clients, idx.shape[1]))
            vals_all = vals.new_empty((n_clients, vals.shape[1]))
            _all_gather(idx_all, idx.contiguous(), group)
            _all_gather(vals_all, vals.contiguous(), group)
            s = torch.sum(_rows(idx_all, vals_all.to(x.dtype), t), dim=0) / n_clients
            rest = torch.cat([torch.sum(grad_c, dim=0), torch.sum(l_c)[None],
                              torch.sum(f_c)[None]])
            dist.all_reduce(rest, group=group)
        grad, l, f = rest[:d] / n_clients, rest[d] / n_clients, rest[d + 1] / n_clients
        # uplink bits under the Section-7 encodings, summed over the world
        counts = torch.stack([torch.sum(sent_c.to(torch.int64)), torch.sum(pay_fn(sent_c)),
                              torch.sum(wire_fn(sent_c))])
        dist.all_reduce(counts, group=group)
        sent, bits_payload, bits_wire = counts[0], counts[1], counts[2]

        x_new = master_step(x, h_global, grad, l, cfg)
        h_global_new = h_global + alpha * s
        gn = torch.linalg.vector_norm(grad)
        return (h_loc_new, x_new, h_global_new, gn, f, l, sent, bits_payload, bits_wire)

    return step


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """The ranks' ``inp`` concatenated along dim 0 into ``out``."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, inp, group=group)


def make_sharded_fednl_round(
    z: torch.Tensor, cfg: FedNLConfig, group=None,
    aggregate: str = "dense_psum", payload_dtype: torch.dtype | None = None,
) -> Callable[[FedNLState], tuple[FedNLState, RoundMetrics]]:
    """The sharded round; ``z`` is this rank's block (:func:`shard_problem`)."""
    _, world = rank_and_world(group)
    n_loc, _, d = z.shape
    step = make_sharded_fednl_step(n_loc * world, d, cfg, group, aggregate, payload_dtype)

    def round_fn(state: FedNLState) -> tuple[FedNLState, RoundMetrics]:
        key, sub = prng.split(state.key, 2)
        (h_loc_new, x_new, h_global_new, gn, f, l, sent,
         bits_payload, bits_wire) = step(z, state.h_local, state.x, state.h_global, sub)
        new_state = FedNLState(x=x_new, h_local=h_loc_new, h_global=h_global_new,
                               key=key, round=state.round + 1)
        return new_state, RoundMetrics(
            grad_norm=gn, f=f, l=l, sent_elems=sent,
            sent_bits=bits_payload if cfg.accounting == "payload" else bits_wire,
            sent_bits_payload=bits_payload, sent_bits_wire=bits_wire,
        )

    return round_fn


class ShardRunner:
    """One rank's part of a sharded run in the default group, stepped as
    the local backend steps (``core.runner.RoundLoop``: init, a warm-up
    round outside the clock, then chunks with one host sync each): its
    block ``z`` of the clients (n_clients / world, n_i, d), the state and
    the round.

    ``restore``: FNLS1 state arrays of the whole run; the rank takes its
    block of ``state.h_local`` and the replicated rest."""

    def __init__(self, z, cfg: FedNLConfig, *, seed: int, aggregate: str,
                 device: torch.device, restore: dict | None = None):
        rank, _ = rank_and_world()
        n_loc = z.shape[0]

        def start(zd):
            state = sharded_fednl_init(zd, cfg, seed=seed)
            if restore is not None:
                arrays = dict(restore)
                arrays["state.h_local"] = arrays["state.h_local"][rank * n_loc:(rank + 1) * n_loc]
                state = state_from_numpy(arrays, zd.device)
            return state, make_sharded_fednl_round(zd, cfg, aggregate=aggregate)

        self.loop = RoundLoop(z, device, start)

    def step(self, n: int) -> dict[str, np.ndarray]:
        """``n`` rounds; their metrics as host columns by name."""
        return metric_columns(self.loop.step(n))

    def snapshot(self) -> dict[str, np.ndarray]:
        """The state's checkpoint arrays, ``h_local`` gathered from every
        rank (the reference's names and shapes)."""
        state = self.loop.state
        _, world = rank_and_world()
        h_all = state.h_local.new_empty((state.h_local.shape[0] * world, state.h_local.shape[1]))
        _all_gather(h_all, state.h_local.contiguous(), None)
        return state_to_numpy(state._replace(h_local=h_all))

    def x(self) -> np.ndarray:
        return self.loop.state.x.cpu().numpy()

    @property
    def init_time_s(self) -> float:
        return self.loop.init_time_s

    def close(self) -> None:
        """Nothing to release: the group outlives the run."""

