"""Batched multi-spec FedNL rounds: the round behind ``solve_many``'s groups
(port of ``repro.core.fednl_batch``).

A sweep group is S specs that share every shape-setting hyper-parameter
(problem shape, algorithm, option, alpha, rounds, ...) and vary in seed,
compressor and, under ``batch="vmap"``, data.  Their states are stacked on a
leading spec axis -- x (S, d), h_local (S, n, T), h_global (S, T), the keys
(S, 2) on the host -- and one round advances all of them, with the clients
of all specs flattened to S * n rows:

  * the SYRK kernel: one launch on the S * n clients (a shared z is read as
    z[c mod n], ``kernels/hessian_syrk.py``, never copied);
  * the compressors: one call per branch (name, k) on the rows of the
    branch's specs -- one selection launch per branch, and the per-entry
    uniforms of RandK (f32) and Natural (f64) in one threefry launch per
    dtype for every row that needs them; the host draws (the key splits,
    RandSeqK's starts, TopLEK's uniforms) one vectorised call for all the
    specs concerned;
  * the master: the means over clients, ``cholesky_ex`` and the triangular
    solves on (S, d, d), with no host sync.

Every reduction over one spec's own rows (the means over clients and over
samples, the norms, the Frobenius norms of the client deltas) reads them from
a copy whose spec blocks each start on a 32-byte boundary (``_aligned``), as
the spec's lone tensors do in its own ``solve()``.  CUDA's reductions load
four elements at a time from a row's first boundary, so the place of a row
decides the order of its sum.  On the stacked rows a spec's bits depended on
its slot in the group: on an H100, the mean over (12, 142) and the clients'
Frobenius norms gave other bits on the odd slots, the sum of squares and the
norm over (12, 301) on slots 1, 2 (and 3) of every four; from aligned blocks,
on none (``chip_smoke.py`` phase 8, ``slot_alignment``).  The batched
Cholesky takes no layout of ours and gave every slot the same bits.

Two layouts of the client oracles' matrix-vector products:

  "scan" (``batch="auto"``): the group shares one z, and the margins Z x
        and the products Z^T v run one per spec, the calls the sequential
        round makes.  Everything else in the round reduces or acts per row,
        so on the CPU every spec's trajectory is bit-identical to its own
        ``solve()`` (the batched GEMM's sums differ from the GEMV's by ulps,
        measured on the CPU; the reference's lax.map layout has the same
        bar).  On the card it is not: on an H100 the batched Cholesky
        factor differs from the (d, d) one for every spec (``chip_smoke.py``
        phase 8, ``bitwise_by_op``); the group agrees with the solves within
        the rtol that phase 8 holds it to, and specs that compute the same
        trajectory agree bit for bit whatever their slots.
  "vmap" (``batch="vmap"``): the products batch over the specs, one GEMM
        reading z once (or one batched product over stacked per-spec data),
        and the group may span datasets of one shape.  Bit identity is
        waived, as it is for the reference's vmap.

A branch whose specs are contiguous in the group (the sweep engine orders a
group by branch) works on views of the rows; other orders gather with
``index_select`` and scatter back with ``index_copy`` (a serving tick's
slots are in tenant order, so mixed compressors usually take that form).
FedNL-LS's Armijo trials run as a host loop over the specs still searching:
one host sync for the plateau test and one per trial, for the whole group.

:class:`BatchRoundTable` is the serving engine's form (``serve_fednl``): a
growable branch table and one round a tick over slots that sit at different
rounds (``state.round`` is then a host array, one round index a slot; the
round reads it nowhere but to advance it).  A tenant's group size changes
from tick to tick (1, 2, 4 or 8 slots under the power-of-two padding); on
an H100 the Cholesky of a batch of one gives the (d, d) call's bits, so a
tenant served alone is its ``solve()`` bit for bit, and batches of 2, 4
and 8 give one another's bits, which part from the (d, d) call's within
1.3e-10 relative on grad norms >= 1e-10 (``chip_smoke.py`` phase 12 (b),
NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api.accounting import payload_bits_fn, wire_bits_fn
from repro_torch.compressors import Compressor
from repro_torch.compressors.core import device_uniform, upload_draws
from repro_torch.core.fednl import FedNLConfig, FedNLState, master_step
from repro_torch.kernels import ops as kops
from repro_torch.linalg import (
    newton_solve_optionA,
    newton_solve_optionB,
    triu_size,
    unpack_triu,
)
from repro_torch.linalg.triu import _offdiag_weights
from repro_torch.objectives.logreg import _matvec, _rmatvec, _softplus

VECTORIZE = ("scan", "vmap")


class BatchRoundMetrics(NamedTuple):
    """One round's metrics for each spec of the group: (S,) each."""

    grad_norm: torch.Tensor
    f: torch.Tensor
    l: torch.Tensor
    sent_elems: torch.Tensor
    sent_bits: torch.Tensor
    sent_bits_payload: torch.Tensor
    sent_bits_wire: torch.Tensor


class BatchLSRoundMetrics(NamedTuple):
    grad_norm: torch.Tensor
    f: torch.Tensor
    l: torch.Tensor
    ls_steps: np.ndarray  # (S,) int64, counted on the host
    sent_elems: torch.Tensor
    sent_bits: torch.Tensor
    sent_bits_payload: torch.Tensor
    sent_bits_wire: torch.Tensor


# ---------------------------------------------------------------------------
# the group's data and oracles
# ---------------------------------------------------------------------------


# elements a CUDA reduction loads at once: 32 bytes of f64
_ALIGN = 4


def _spec_blocks(v: torch.Tensor) -> torch.Tensor:
    """An empty tensor of v's shape (S, ...) whose spec blocks each start on
    a 32-byte boundary, each block contiguous."""
    size = v[0].numel()
    pitch = -(-size // _ALIGN) * _ALIGN
    return v.new_empty((v.shape[0], pitch))[:, :size].view(v.shape)


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """v (S, ...) with each spec's block starting on a 32-byte boundary, as
    the spec's lone tensor does: v itself where every block already does,
    else a copy (module docstring)."""
    if v[0].numel() % _ALIGN == 0 and v.data_ptr() % (v.element_size() * _ALIGN) == 0:
        return v
    out = _spec_blocks(v)
    out.copy_(v)
    return out


def _client_frob_norms(delta: torch.Tensor, s_count: int, d: int) -> torch.Tensor:
    """``linalg.frob_norm_from_packed`` of every client's row of delta
    (S * n, T), the squares written to spec-aligned blocks: (S, n)."""
    u = delta.view(s_count, -1, delta.shape[-1])
    sq = _spec_blocks(u)
    torch.mul(_offdiag_weights(d, u.dtype, u.device) * u, u, out=sq)
    return torch.sqrt(torch.sum(sq, dim=-1))


def _f_clients(m: torch.Tensor, xs: torch.Tensor, lam: float) -> torch.Tensor:
    """Each client's f from the margins m (S, n, n_i): (S, n)."""
    return (torch.mean(_aligned(_softplus(-m)), dim=-1)
            + 0.5 * lam * torch.sum(_aligned(xs * xs), dim=-1)[:, None])


def _dims(z: torch.Tensor) -> tuple[int, int, int]:
    """(n_clients, n_i, d) of a shared z (n, n_i, d) or stacked z (S, n, n_i, d)."""
    return tuple(z.shape[-3:])


def _check_layout(z: torch.Tensor, vectorize: str) -> None:
    if vectorize not in VECTORIZE:
        raise ValueError(f"unknown vectorize {vectorize!r}; use {' | '.join(VECTORIZE)}")
    if z.ndim not in (3, 4):
        raise ValueError(f"need z (n, n_i, d) or (S, n, n_i, d), got {tuple(z.shape)}")
    if vectorize == "scan" and z.ndim != 3:
        raise ValueError("the 'scan' layout runs a group on one shared z (n, n_i, d)")


def _margins(z: torch.Tensor, xs: torch.Tensor, exact: bool, specs=None) -> torch.Tensor:
    """Z x for each spec: xs (S', d) -> (S', n, n_i).  ``specs`` picks the
    specs' data from a stacked z (all of them when None)."""
    n, n_i, d = _dims(z)
    if exact:
        return torch.stack([_matvec(z, x) for x in xs])
    if z.ndim == 3:  # one GEMM reads z once for all the specs
        return (xs @ z.reshape(n * n_i, d).mT).view(-1, n, n_i)
    zs = z if specs is None else z[torch.as_tensor(specs, device=z.device)]
    return torch.bmm(zs.reshape(-1, n * n_i, d), xs[:, :, None]).view(-1, n, n_i)


def batch_oracles(z: torch.Tensor, xs: torch.Tensor, lam: float, exact: bool):
    """(f, grad, packed hess) of every client under every spec's x from one
    margin/sigmoid pass: f (S, n), grad (S, n, d), hess (S * n, T), the
    Hessians in one SYRK launch.  The op order is
    ``objectives.logreg.logreg_oracles_packed``'s, spec by spec."""
    n, n_i, d = _dims(z)
    s_count = xs.shape[0]
    m = _margins(z, xs, exact)
    sigma = torch.sigmoid(m)
    f = _f_clients(m, xs, lam)
    v = 1.0 - sigma
    if exact:
        r = torch.stack([_rmatvec(z, v_s) for v_s in v])
    elif z.ndim == 3:  # per client one product with the S specs' columns
        r = (z.mT @ v.permute(1, 2, 0)).permute(2, 0, 1)
    else:
        r = torch.bmm(z.reshape(-1, n_i, d).mT, v.reshape(-1, n_i, 1)).view(s_count, n, d)
    grad = -r / n_i + lam * xs[:, None, :]
    hw = sigma * (1.0 - sigma) / n_i
    z_rows = z if z.ndim == 3 else z.reshape(-1, n_i, d)
    hess = kops.hessian_syrk_packed(z_rows, hw.reshape(s_count * n, n_i).contiguous(), lam)
    return f, grad, hess


def _f_global(z: torch.Tensor, xs: torch.Tensor, lam: float, exact: bool, specs) -> torch.Tensor:
    """mean_c f_c(x) for each row of xs (the specs ``specs`` of the group)."""
    if exact:
        from repro_torch.objectives.logreg import logreg_f

        return torch.stack([torch.mean(logreg_f(z, x, lam)) for x in xs])
    return torch.mean(_aligned(_f_clients(_margins(z, xs, exact, specs), xs, lam)), dim=1)


def fednl_batch_init(
    z: torch.Tensor, cfg: FedNLConfig, seeds: Sequence[int], vectorize: str = "scan"
) -> FedNLState:
    """The stacked initial states of ``len(seeds)`` specs (x = 0), as
    ``core.fednl.fednl_init`` makes each, with the Hessians at x = 0 in one
    SYRK launch."""
    _check_layout(z, vectorize)
    n, _, d = _dims(z)
    s_count = len(seeds)
    x = torch.zeros((s_count, d), dtype=z.dtype, device=z.device)
    if cfg.hess0 == "exact":
        h_local = batch_oracles(z, x, cfg.lam, vectorize == "scan")[2].view(s_count, n, -1)
    elif cfg.hess0 == "zero":
        h_local = torch.zeros((s_count, n, triu_size(d)), dtype=z.dtype, device=z.device)
    else:
        raise ValueError(f"unknown hess0 {cfg.hess0!r}")
    return FedNLState(
        x=x,
        h_local=h_local,
        h_global=torch.mean(h_local, dim=1),
        key=np.stack([prng.prng_key(int(s)) for s in seeds]),
        round=0,
    )


# ---------------------------------------------------------------------------
# compressor branches
# ---------------------------------------------------------------------------


class _Branch:
    """One (compressor, k) of the group: its specs, its rows of the flat
    (S * n) client axis (a slice when its specs are contiguous), its bit
    models."""

    def __init__(self, comp: Compressor, specs: np.ndarray, n: int, d: int, device):
        self.comp = comp
        self.specs = specs
        self.n_rows = len(specs) * n
        contiguous = bool(np.all(np.diff(specs) == 1))
        self.slice = slice(specs[0] * n, (specs[-1] + 1) * n) if contiguous else None
        self.rows = None if contiguous else torch.as_tensor(
            (specs[:, None] * n + np.arange(n)).reshape(-1), device=device)
        self.pay_fn = payload_bits_fn(comp, d)
        self.wire_fn = wire_bits_fn(comp, d)

    def take(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.slice] if self.rows is None else flat.index_select(0, self.rows)

    def put(self, out: torch.Tensor, value: torch.Tensor) -> None:
        if self.rows is None:
            out[self.slice] = value
        else:
            out.index_copy_(0, self.rows, value)


def _make_branches(comps, comp_idx, n: int, d: int, device) -> list[_Branch]:
    comp_idx = np.asarray(comp_idx)
    used = [b for b in range(len(comps)) if np.any(comp_idx == b)]
    return [_Branch(comps[b], np.nonzero(comp_idx == b)[0], n, d, device) for b in used]


def batch_compress(branches: list[_Branch], sub_keys: np.ndarray, delta: torch.Tensor, n: int):
    """Every spec's compressor on its rows of delta (S * n, T): the clients'
    keys split from each spec's round subkey in one call, the per-entry
    uniforms in one threefry launch per dtype, then one call per branch.
    Returns (u_hat, sent (int32), payload bits, wire bits), each by row."""
    t = delta.shape[-1]
    device = delta.device
    drawing = [b for b in branches if b.comp.draws]
    keys_of: dict[int, np.ndarray] = {}
    if drawing:
        specs = np.concatenate([b.specs for b in drawing])
        keys = prng.split(sub_keys[specs], n)  # (S', n, 2), one vectorised call
        off = 0
        for b in drawing:
            keys_of[id(b)] = keys[off:off + len(b.specs)].reshape(-1, 2)
            off += len(b.specs)
    unif_of: dict[int, torch.Tensor] = {}
    for dtype in (torch.float32, torch.float64):
        users = [b for b in drawing if b.comp.entry_uniform == dtype]
        if users:
            unif = device_uniform(np.concatenate([keys_of[id(b)] for b in users]), t, dtype, device)
            off = 0
            for b in users:
                unif_of[id(b)] = unif[off:off + b.n_rows]
                off += b.n_rows

    if len(branches) == 1:
        b = branches[0]
        u_hat, sent = _compress(b, delta, keys_of.get(id(b)), unif_of.get(id(b)))
        return u_hat, sent, b.pay_fn(sent), b.wire_fn(sent)
    rows = delta.shape[0]
    u_hat = torch.empty_like(delta)
    sent = torch.empty(rows, dtype=torch.int32, device=device)
    pay = torch.empty(rows, dtype=torch.int64, device=device)
    wire = torch.empty(rows, dtype=torch.int64, device=device)
    for b in branches:
        out, sent_b = _compress(b, b.take(delta), keys_of.get(id(b)), unif_of.get(id(b)))
        b.put(u_hat, out)
        b.put(sent, sent_b.to(torch.int32))
        b.put(pay, b.pay_fn(sent_b))
        b.put(wire, b.wire_fn(sent_b))
    return u_hat, sent, pay, wire


def _compress(b: _Branch, u: torch.Tensor, keys, unif):
    if unif is not None:
        return b.comp.compress_from_uniform(u, unif)
    return b.comp.compress(keys, u)


# ---------------------------------------------------------------------------
# the batched rounds
# ---------------------------------------------------------------------------


def _client_phase(z, state: FedNLState, branches, alpha: float, lam: float, exact: bool):
    """Lines 3-7 of Algorithm 1 for every client of every spec, and the
    keys' advance; the op order of ``core.fednl.client_round``."""
    n, _, d = _dims(z)
    s_count = state.x.shape[0]
    split = prng.split(state.key, 2)  # (S, 2, 2): key, sub for every spec
    key, sub = split[:, 0], split[:, 1]
    f_c, grad_c, hess = batch_oracles(z, state.x, lam, exact)
    h_local = state.h_local.reshape(s_count * n, -1)
    delta = hess - h_local
    s_c, sent, pay, wire = batch_compress(branches, sub, delta, n)
    l_c = _client_frob_norms(delta, s_count, d)
    h_local_new = (h_local + alpha * s_c).view(state.h_local.shape)
    sums = (
        torch.sum(sent.to(torch.int64).view(s_count, n), dim=1),
        torch.sum(pay.view(s_count, n), dim=1),
        torch.sum(wire.view(s_count, n), dim=1),
    )
    return key, f_c, grad_c, s_c.view(s_count, n, -1), l_c, h_local_new, sums


def _setup(z, cfg, comps, comp_idx, vectorize):
    _check_layout(z, vectorize)
    n, _, d = _dims(z)
    if z.ndim == 4 and z.shape[0] != len(comp_idx):
        raise ValueError(f"stacked z has {z.shape[0]} specs, comp_idx {len(comp_idx)}")
    return n, d, _make_branches(comps, comp_idx, n, d, z.device)


def make_fednl_batch_round(
    z: torch.Tensor,
    cfg: FedNLConfig,
    comps: Sequence[Compressor],
    comp_idx: Sequence[int],
    alpha: float,
    vectorize: str = "scan",
) -> Callable[[FedNLState], tuple[FedNLState, BatchRoundMetrics]]:
    """The Algorithm-1 round over a group: spec s runs ``comps[comp_idx[s]]``
    under the group's shared ``cfg`` (its compressor fields are ignored) and
    Hessian learning rate ``alpha``; ``z`` is the shared (n, n_i, d) data or,
    for "vmap", the stacked (S, n, n_i, d)."""
    n, d, branches = _setup(z, cfg, comps, comp_idx, vectorize)
    exact = vectorize == "scan"

    def round_fn(state: FedNLState) -> tuple[FedNLState, BatchRoundMetrics]:
        key, f_c, grad_c, s_c, l_c, h_local_new, (elems, pay, wire) = _client_phase(
            z, state, branches, alpha, cfg.lam, exact)
        grad = torch.mean(grad_c, dim=1)
        s = torch.mean(s_c, dim=1)
        l = torch.mean(_aligned(l_c), dim=1)
        f = torch.mean(_aligned(f_c), dim=1)
        x_new = master_step(state.x, state.h_global, grad, l, cfg)
        metrics = BatchRoundMetrics(
            grad_norm=torch.linalg.vector_norm(_aligned(grad), dim=-1),
            f=f,
            l=l,
            sent_elems=elems,
            sent_bits=pay if cfg.accounting == "payload" else wire,
            sent_bits_payload=pay,
            sent_bits_wire=wire,
        )
        new_state = FedNLState(
            x=x_new,
            h_local=h_local_new,
            h_global=state.h_global + alpha * s,
            key=key,
            round=state.round + 1,
        )
        return new_state, metrics

    return round_fn


def make_fednl_ls_batch_round(
    z: torch.Tensor,
    cfg: FedNLConfig,
    comps: Sequence[Compressor],
    comp_idx: Sequence[int],
    alpha: float,
    vectorize: str = "scan",
) -> Callable[[FedNLState], tuple[FedNLState, BatchLSRoundMetrics]]:
    """The Algorithm-2 round over a group (arguments as
    :func:`make_fednl_batch_round`): the backtracking of
    ``core.fednl_ls`` for every spec, its trials batched over the specs
    still searching."""
    n, d, branches = _setup(z, cfg, comps, comp_idx, vectorize)
    exact = vectorize == "scan"

    def round_fn(state: FedNLState) -> tuple[FedNLState, BatchLSRoundMetrics]:
        key, f_c, grad_c, s_c, l_c, h_local_new, (elems, pay, wire) = _client_phase(
            z, state, branches, alpha, cfg.lam, exact)
        grad = torch.mean(grad_c, dim=1)
        f0 = torch.mean(_aligned(f_c), dim=1)
        l = torch.mean(_aligned(l_c), dim=1)
        s = torch.mean(s_c, dim=1)

        h = unpack_triu(state.h_global, d)
        if cfg.option == "A":
            direction = -newton_solve_optionA(h, grad, cfg.mu)
        else:
            direction = -newton_solve_optionB(h, grad, l)
        if exact:
            slope = torch.stack([g @ dd for g, dd in zip(_aligned(grad), _aligned(direction))])
        else:
            slope = torch.sum(_aligned(grad * direction), dim=-1)
        grad_norm = torch.linalg.vector_norm(_aligned(grad), dim=-1)

        s_count = grad.shape[0]
        steps = np.zeros(s_count, dtype=np.int64)
        step = np.ones(s_count)
        searching = (grad_norm > cfg.ls_tol).cpu().numpy()  # off the plateau
        while True:
            live = np.nonzero(searching & (steps < cfg.ls_max_steps))[0]
            if live.size == 0:
                break
            idx = upload_draws(live, z.device)
            step_live = upload_draws(step[live], z.device)
            f_try = _f_global(
                z, state.x[idx] + step_live[:, None] * direction[idx], cfg.lam, exact, live)
            c_step = upload_draws(cfg.ls_c * step[live], z.device)
            fail = (f_try > f0[idx] + c_step * slope[idx]).cpu().numpy()
            steps[live[fail]] += 1
            step[live[fail]] *= cfg.ls_gamma
            searching[live[~fail]] = False
        x_new = state.x + upload_draws(step, z.device)[:, None] * direction

        metrics = BatchLSRoundMetrics(
            grad_norm=grad_norm,
            f=f0,
            l=l,
            ls_steps=steps,
            sent_elems=elems,
            sent_bits=pay if cfg.accounting == "payload" else wire,
            sent_bits_payload=pay,
            sent_bits_wire=wire,
        )
        new_state = FedNLState(
            x=x_new,
            h_local=h_local_new,
            h_global=state.h_global + alpha * s,
            key=key,
            round=state.round + 1,
        )
        return new_state, metrics

    return round_fn


# ---------------------------------------------------------------------------
# the serving engine's round table
# ---------------------------------------------------------------------------


class BatchRoundTable:
    """One round a tick over a growable compressor table, for one serve group
    key (one problem ``z``, one group-shared config and Hessian learning
    rate): port of ``repro.core.fednl_batch.BatchRoundTable``.

    The serving engine re-forms its groups every tick as tenants are
    admitted, finish or spill, so what it keeps is this table:

      * the group's compressor branches, appended as tenants with new
        (compressor, k) pairs arrive, so a tenant's branch index never
        changes meaning;
      * ``tick(comp_idx, state_b)`` advances every slot one round.

    The reference compiles one tick program per (table length, slot count)
    and passes ``comp_idx`` to it; here a round is built for a pattern of
    branch indices (``make_fednl_batch_round`` takes them when it is built:
    each branch's rows and index tensors), and the last ``_CACHED`` patterns
    are kept, so a re-formed group with a pattern seen before builds nothing.
    ``compiles`` counts what the reference counts, one per new (table
    length, slot bucket) key, so the engine's ``stats()["compiles"]`` and
    its ``engine.tick`` spans equal the reference's tick for tick.

    Padding slots duplicate live states (``serve_fednl.scheduler``): every
    op of the round acts per slot, and every reduction over a slot's own
    rows reads them from a block on a 32-byte boundary (``_aligned``), so a
    pad slot does not shape a live slot's bits.
    """

    _CACHED = 32  # rounds kept, by branch-index pattern

    def __init__(self, z, cfg: FedNLConfig, alpha: float,
                 make_batch_round: Callable | None = None):
        self.z = z
        self.cfg = cfg
        self.alpha = alpha
        self._make = make_fednl_batch_round if make_batch_round is None else make_batch_round
        self.branch_keys: list[tuple[str, int]] = []
        self._comps: list[Compressor] = []
        self._programs: set[tuple[int, int]] = set()  # (table length, slots) seen
        self._rounds: OrderedDict[tuple[int, ...], Callable] = OrderedDict()
        self.compiles = 0

    def branch_index(self, name: str, k: int) -> int:
        """Index of compressor ``(name, k)`` in the table, appending (and
        building the Compressor) on first sight."""
        from repro_torch.compressors import get_compressor

        bk = (name, int(k))
        if bk not in self.branch_keys:
            self.branch_keys.append(bk)
            self._comps.append(get_compressor(name, triu_size(self.z.shape[-1]), int(k)))
        return self.branch_keys.index(bk)

    def bucket_for(self, n: int, pad_pow2: bool = True) -> int:
        """Slot count to pad ``n`` live slots to: the smallest bucket already
        seen at this table length that fits (a draining group keeps its
        bucket), else the next power of two."""
        if not pad_pow2:
            return n
        fitting = [m for (n_comps, m) in self._programs if n_comps == len(self._comps) and m >= n]
        if fitting:
            return min(fitting)
        b = 1
        while b < n:
            b *= 2
        return b

    def tick(self, comp_idx: Sequence[int], state_b):
        """Advance every slot one round: ``(state_b', metrics_b)``.

        ``comp_idx``: (n_slots,) branch indices; ``state_b``: the algorithm
        state stacked along a leading slot axis, ``round`` a host array.
        """
        pattern = tuple(int(c) for c in comp_idx)
        key = (len(self._comps), len(pattern))
        if key not in self._programs:
            self._programs.add(key)
            self.compiles += 1
        round_fn = self._rounds.get(pattern)
        if round_fn is None:
            round_fn = self._make(self.z, self.cfg, list(self._comps), pattern, self.alpha, "scan")
            self._rounds[pattern] = round_fn
            if len(self._rounds) > self._CACHED:
                self._rounds.popitem(last=False)
        else:
            self._rounds.move_to_end(pattern)
        return round_fn(state_b)
